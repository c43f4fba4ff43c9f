"""The training step on one device: gradient accumulation, the frozen LM
without gradients, the optimizer, eval, caption generation and checkpoints.

Port of the single-device part of ``magma_tpu/training/train_loop.py``
(reference magma/train_loop.py:7-98, train.py:103-111):

* the Trainer owns the parameters: the frozen ones (the LM outside its
  adapters, and the image encoder with ``freeze_img_encoder``) get
  ``requires_grad=False``, so no gradient is computed for the 6B weights;
* a global batch (ga, micro_batch, ...) is ga forward/backward passes of
  ``Magma.loss_fn``; with ga > 1 the gradients accumulate in fp32 and are
  cast back to each parameter's dtype before the optimizer, as the JAX
  package does (``train_loop.py:139-146``), and the BN state threads from
  one micro-batch to the next;
* ``run_blind`` zeroes the images (train_loop.py:13-14); ``eval_step``
  averages the loss under ``torch.no_grad``; ``inference_step`` captions
  eval images; ``save``/``load`` keep the JAX checkpoint layout;
* ``train_step_classification`` / ``eval_step_classification`` run a
  ``MagmaClassifier``'s loss (train_loop.py:262-340) through the same
  accumulation, clipping and AdamW (a flat batch split into ga
  micro-batches; the mean of equal micro-batches' mean gradients is the
  whole batch's, which JAX takes in one pass).

Host batches (the loader's pinned tensors) are copied to the card with
``non_blocking=True``.  Dropout bits come from a ``torch.Generator`` seeded
by (seed, step); the JAX package's ``jax.random`` bits cannot be
reproduced.

The mesh (``train_loop.py:43-95``): ``Trainer(model, config, mesh=None)``
takes one from ``mesh_dp``/``mesh_tp``/``mesh_sp`` (``parallel/mesh.py``;
one process per rank).  The model comes with its full tree, as the JAX
package's Trainer takes it, and the Trainer keeps this rank's shards: the
frozen LM sharded by ``param_spec``, the trainable tree replicated.  The
steps take this rank's "dp" share of each batch, as the multi-process
loader gives it (a caller holding the global batch (ga, micro_b, ...)
slices it with ``sharding.shard_batch(t, mesh, 1)``).  Each rank's loss is its share of the
global NLL sum over the global count (``Magma._mesh_loss``), so the
replicated parameters' gradients are summed over "dp" and "sp" (one
all_reduce of one flat buffer) before AdamW, which then takes the same
decisions on every rank; the optimizer state stays replicated, as in the
JAX package, whose state inherits the replicated shardings.  Checkpoints
gather the tp shards and are written by rank 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from magma_tpu_torch import observability as obs
from magma_tpu_torch.config import MultimodalConfig
from magma_tpu_torch.parallel import sharding
from magma_tpu_torch.parallel.mesh import all_reduce, make_mesh
from magma_tpu_torch.training.optim import AdamW
from magma_tpu_torch.utils import is_main, tree_items, tree_map


class Trainer:
    """Owns the parameters, the BN state and the optimizer of a ``Magma``."""

    def __init__(self, model, config: MultimodalConfig, mesh=None):
        self.model = model
        self.config = config
        self.device = model.device
        self.mesh = mesh if mesh is not None else make_mesh(
            config.mesh_dp, config.mesh_tp, config.mesh_sp)
        ring = model.lm_config.attention_impl == "ring"
        if ring and model.lm_config.sp_axis not in self.mesh.axis_names:
            raise ValueError(
                f"attention_impl='ring' needs a mesh with an '{model.lm_config.sp_axis}' axis "
                f"(set mesh_sp > 1); got axes {self.mesh.axis_names}")
        # the model runs its parallel layers over the mesh once there is one
        # to run over (a single process keeps its single-device path)
        if self.mesh.distributed or ring:
            model.mesh = self.mesh
        self.global_step = 0
        self._mask = model.trainable_mask()
        self.params = sharding.shard_params(self.mesh, model.params)
        self.state = model.state
        # the Trainer owns the tensors from here; sync_model() hands them back
        model.params = model.state = None
        self.trainable = []
        for (path, t), (_, m) in zip(tree_items(self.params), tree_items(self._mask)):
            t.requires_grad_(bool(m))
            if m:
                self.trainable.append((path, t))
        self.optimizer = AdamW(config, self.trainable)

    # ------------------------------------------------------------------
    def sync_model(self) -> None:
        """Hand the current params and state back to the ``Magma`` facade
        (generation, checkpointing through the model's API)."""
        self.model.params = self.params
        self.model.state = self.state

    def _to_device(self, x) -> torch.Tensor:
        """A host array or tensor on the trainer's device; a pinned host
        tensor is copied asynchronously."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self.device, non_blocking=True)

    def _batch(self, images, captions):
        """This rank's batch on the device."""
        with obs.span("train.batch"):
            images = self._to_device(images).float()
            captions = self._to_device(captions).long()
            if self.config.run_blind:
                images = torch.zeros_like(images)
        return images, captions

    def _sum_over_data(self, tensors):
        """Each tensor summed over "dp" and "sp" through one flat fp32
        buffer, cast back to its dtype; the tensors themselves without a
        mesh to sum over."""
        if self.mesh.group(("dp", "sp")) is None:
            return tensors
        flat = all_reduce(torch.cat([t.float().reshape(-1) for t in tensors]), self.mesh,
                          ("dp", "sp"))
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
            i += t.numel()
        return out

    def _generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed * 1_000_003 + self.global_step)
        return gen

    def _accumulate_and_step(self, n: int, micro_loss):
        """One optimizer step over ``n`` micro-batches: ``micro_loss(i,
        state, generator)`` -> (loss, new state, aux) of micro-batch i.  The
        gradients accumulate in fp32 when n > 1 and are averaged and cast to
        the params' dtypes; the BN state threads through.  Returns (mean
        loss as a device scalar, [aux of each micro-batch])."""
        gen = self._generator()
        tensors = [t for _, t in self.trainable]
        state = self.state
        acc = loss_sum = None
        auxes = []
        obs.count("train.micro_batches", n)
        for i in range(n):
            with obs.span("train.micro", i=i):
                with obs.span("train.forward"):
                    loss, state, aux = micro_loss(i, state, gen)
                auxes.append(aux)
                with obs.span("train.backward"):
                    grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                                materialize_grads=True)
                with obs.span("train.accumulate"):
                    if n == 1:  # no fp32 accumulators: the grads are in the params' dtypes
                        acc, loss_sum = list(grads), loss.detach()
                    elif acc is None:
                        acc, loss_sum = [g.float() for g in grads], loss.detach()
                    else:
                        for a, g in zip(acc, grads):
                            a.add_(g.float())
                        loss_sum = loss_sum + loss.detach()
                del grads
        if n > 1:
            with obs.span("train.accumulate"):
                acc = [(a / n).to(t.dtype) for a, t in zip(acc, tensors)]
                loss_sum = loss_sum / n
        if self.mesh.group(("dp", "sp")) is not None:  # else both are the tensors as they are
            with obs.span("train.reduce"):
                acc = self._sum_over_data(acc)
                loss_sum = all_reduce(loss_sum.clone(), self.model.mesh, ("dp", "sp"))
        with obs.span("train.optimizer"):
            self.optimizer.step(acc)
        self.state = tree_map(lambda t: t.detach(), state)
        self.global_step += 1
        return loss_sum, auxes

    def train_step(self, images, captions, sync: bool = True):
        """One optimizer step over this rank's "dp" share of a global batch,
        laid out as (ga, micro_batch / dp, ...) (a flat (B / dp, ...) batch
        is split into ga micro-batches).  Returns the global mean loss: a
        float, or with ``sync=False`` a device scalar, so the host does not
        wait."""
        ga = self.config.gradient_accumulation_steps
        with obs.span("train.step", step=self.global_step):
            if np.ndim(images) == 4:
                images = images.reshape(ga, -1, *images.shape[1:])
                captions = captions.reshape(ga, -1, captions.shape[-1])
            images, captions = self._batch(images, captions)
            obs.count("train.samples", images.shape[0] * images.shape[1])

            def micro(i, state, gen):
                loss, (state, _) = self.model.loss_fn(self.params, state, images[i],
                                                      captions[i], train=True, generator=gen)
                return loss, state, None

            loss, _ = self._accumulate_and_step(images.shape[0], micro)
            if not sync:
                return loss
            with obs.span("train.loss_read"):
                return float(loss)

    @torch.no_grad()
    def eval_step(self, eval_loader, eval_steps: Optional[int] = None) -> float:
        """Mean loss over ``eval_steps`` flat batches (train_loop.py:48-60),
        each the global batch's loss; the loader gives this rank's share."""
        n = eval_steps if eval_steps is not None else self.config.eval_steps
        losses = []
        for _ in range(n):
            images, captions = self._batch(*next(eval_loader))
            loss, _ = self.model.loss_fn(self.params, self.state, images, captions, train=False)
            losses.append(float(all_reduce(loss.clone(), self.model.mesh, ("dp", "sp"))))
        return float(np.mean(losses))

    def inference_step(self, eval_loader, max_images: int = 2,
                       **generate_kwargs) -> Tuple[np.ndarray, str]:
        """Captions for eval images (train_loop.py:85-98, done as intended).
        Returns (images, caption text block)."""
        images, _ = next(eval_loader)
        images = np.asarray(images)[:max_images]
        if self.config.run_blind:
            images = np.zeros_like(images)
        self.sync_model()
        embeddings = self.model.embed([torch.as_tensor(images, device=self.device)])
        captions = self.model.generate(embeddings, **generate_kwargs)
        return images, "".join(f"Caption {i}: \n{c}\n" for i, c in enumerate(captions))

    # ------------------------------------------------------------------
    # Classification fine-tuning (a MagmaClassifier's loss)
    # ------------------------------------------------------------------
    def _classification_batch(self, images, captions, class_labels):
        images = ([self._to_device(i).float() for i in images]
                  if isinstance(images, (list, tuple)) else [self._to_device(images).float()])
        return images, self._to_device(captions).long(), self._to_device(class_labels).long()

    def train_step_classification(self, images, captions, class_labels,
                                  return_accuracy: bool = True):
        """One optimizer step of the classification loss over this rank's
        "dp" share of a flat batch (``images`` one (B / dp, 3, H, W) batch or
        a list, one per image position), split into ga micro-batches.
        Returns the global mean loss (and the global batch's accuracy) as
        floats."""
        ga = self.config.gradient_accumulation_steps
        with obs.span("train.step", step=self.global_step):
            with obs.span("train.batch"):
                images, captions, labels = self._classification_batch(images, captions,
                                                                      class_labels)
            obs.count("train.samples", captions.shape[0])

            def split(t):  # (ga, micro / dp, ...)
                return t.reshape(ga, -1, *t.shape[1:])

            images, captions, labels = [split(i) for i in images], split(captions), split(labels)

            def micro(i, state, gen):
                loss, (state, logits) = self.model.classification_loss_fn(
                    self.params, state, [img[i] for img in images], captions[i], labels[i],
                    train=True, generator=gen)
                return loss, state, logits.detach()

            loss, logits = self._accumulate_and_step(ga, micro)
            correct = (torch.cat(logits).argmax(-1) == labels.reshape(-1)).float().sum()
            acc = all_reduce(correct, self.model.mesh, "dp") / (labels.numel()
                                                                * self.mesh.size("dp"))
            with obs.span("train.loss_read"):
                return (float(loss), float(acc)) if return_accuracy else float(loss)

    @torch.no_grad()
    def eval_step_classification(self, images, captions, class_labels,
                                 return_accuracy: bool = True):
        """The classification loss (and accuracy) of one batch, train=False
        (over a mesh: this rank's "dp" share in, the results global)."""
        images, captions, labels = self._classification_batch(images, captions, class_labels)
        loss, (_, logits) = self.model.classification_loss_fn(
            self.params, self.state, images, captions, labels, train=False)
        loss = all_reduce(loss.clone(), self.model.mesh, "dp")
        correct = (logits.argmax(-1) == labels).float().sum()
        acc = all_reduce(correct, self.model.mesh, "dp") / (labels.numel() * self.mesh.size("dp"))
        return (float(loss), float(acc)) if return_accuracy else float(loss)

    # ------------------------------------------------------------------
    def save(self, save_dir: str) -> None:
        """Write the checkpoint on rank 0; under tp every rank first joins
        the gathers of the LM's shards."""
        from magma_tpu_torch.training import checkpoint as ckpt

        params = sharding.unshard_params(self.mesh, self.params, self.model.lm_config)
        if is_main():
            ckpt.save_checkpoint(save_dir, self.global_step, params, self.state,
                                 opt_state=self.optimizer.state_dict(), config=self.config)

    def load(self, load_dir: str, load_optimizer: bool = True) -> int:
        """Resume; returns the restored global step (0 when nothing was
        found), as utils.py:99-117.  The checkpoint is checked against the
        whole tree and copied into the live tensors in place
        (``checkpoint.load_checkpoint``); under tp into the gathered tree,
        whose shards this rank then keeps.  A key or a shape that differs
        raises a ``ValueError`` naming the leaf, and nothing is restored."""
        from magma_tpu_torch.training import checkpoint as ckpt

        full = sharding.unshard_params(self.mesh, self.params, self.model.lm_config)
        params, _, opt_state, step = ckpt.load_checkpoint(
            load_dir, full, self.state, self.optimizer.state_dict() if load_optimizer else None)
        if params is None:
            return 0
        if full is not self.params:
            with torch.no_grad():
                shards = sharding.shard_params(self.mesh, params)
                for (_, t), (_, r) in zip(tree_items(self.params), tree_items(shards)):
                    t.copy_(r)
        if load_optimizer and opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
            self.global_step = step
        return step
