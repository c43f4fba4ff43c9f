"""Classification fine-tuning: Magma with a linear class head.

Port of ``magma_tpu/models/classifier.py`` (the reference's
``class_dict`` knobs, magma/config.py:82,97, its classification train and
eval steps, train_loop.py:24-45,63-82, and its NLVR2 multi-image collate,
utils.py:272-282):

* ``MagmaClassifier`` = ``Magma`` + a zero-initialised linear head over the
  LM's hidden state after ``ln_f``, read at the ``class_dict``'s
  ``interface_type``: "last_token" (the first EOS of the caption, or the
  last position) or "mean_pool" (the mean over all positions);
* several images a sample (NLVR2 pairs): each runs the image prefix, and
  the sequence is [img_0 tokens, img_1 tokens, ..., caption]; in training
  each image's dropout bits are drawn from the generator in that order;
* ``freeze_model`` trains the head alone.

The hidden states come from ``gptj.forward(return_hidden=True)``, so on the
card the flash forward (K1) and, under autograd, its backward (K9a, K9b)
carry the classifier as they carry the caption loss.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from magma_tpu_torch.models import gptj, image_prefix as ip_mod
from magma_tpu_torch.models.magma import Magma
from magma_tpu_torch.utils import tree_map


class MagmaClassifier(Magma):
    """Magma with a classification head.  ``config.class_dict`` must give
    ``num_classes``; ``classifier_type`` is "linear", ``interface_type``
    "last_token" (default) or "mean_pool", ``freeze_model`` False by
    default."""

    def __init__(self, config, seed: int = 0, device="cuda", init_weights: bool = True):
        super().__init__(config, seed=seed, device=device, init_weights=init_weights)
        cd = self.config.class_dict or {}
        if not cd:
            raise ValueError("MagmaClassifier requires config.class_dict")
        self.num_classes = int(cd["num_classes"])
        self.classifier_type = cd.get("classifier_type", "linear")
        self.interface_type = cd.get("interface_type", "last_token")
        if self.classifier_type != "linear":
            raise ValueError(f"classifier_type {self.classifier_type!r} is not 'linear'")
        if self.interface_type not in ("last_token", "mean_pool"):
            raise ValueError(f"interface_type {self.interface_type!r} is not 'last_token' "
                             "or 'mean_pool'")
        self.freeze_model = bool(cd.get("freeze_model", False))
        if init_weights:
            # zero-initialised: an untrained head predicts exactly uniform
            d = self.lm_config.d_model
            self.params["class_head"] = {
                "kernel": torch.zeros((d, self.num_classes), device=self.device),
                "bias": torch.zeros(self.num_classes, device=self.device)}

    def trainable_mask(self):
        """Magma's mask with the head trainable; with ``freeze_model``
        the head alone."""
        mask = super().trainable_mask()
        if self.freeze_model:
            mask = tree_map(lambda _: False, mask)
        if "class_head" in self.params:
            mask["class_head"] = tree_map(lambda _: True, self.params["class_head"])
        return mask

    # ------------------------------------------------------------------
    def classification_loss_fn(self, params, state, images, captions: torch.Tensor,
                               class_labels: torch.Tensor, *, train: bool = True,
                               generator: Optional[torch.Generator] = None):
        """(loss, (new_state, fp32 logits)); ``images`` is one (b, 3, H, W)
        batch or a list of them (one per image position).  The loss is the
        mean cross-entropy of the logits; over ``self.mesh`` (the Trainer's)
        the batch is this rank's "dp" share and the loss its share of the
        global mean, as ``loss_fn``'s.  Ring attention is not taken here."""
        mesh = self.mesh
        if mesh is not None and self.lm_config.attention_impl == "ring":
            raise ValueError("the classifier runs the whole sequence on each rank: no ring")
        if not isinstance(images, (list, tuple)):
            images = [images]
        new_state = state
        prefix_embeds = []
        for img in images:
            emb, new_ip = ip_mod.apply(params["image_prefix"], new_state["image_prefix"], img,
                                       self.prefix_config, train=train, generator=generator,
                                       mesh=mesh)
            prefix_embeds.append(emb)
            new_state = {"image_prefix": new_ip}
        prefix = torch.cat(prefix_embeds, dim=1)

        s_img = prefix.shape[1]
        captions = captions.long()
        word = gptj.embed_tokens(self.lm_config, params["lm"], captions, mesh)
        embeds = torch.cat([prefix, word[:, :self.seq_len - s_img]], dim=1)
        x, _ = gptj.forward(self.lm_config, params["lm"], embeds,
                            remat=self.lm_config.remat and train, return_hidden=True, mesh=mesh)
        b, s, _ = x.shape
        if self.interface_type == "last_token":
            # captions are right-padded with EOS: the first EOS, else the end
            is_eos = captions[:, :self.seq_len - s_img] == self.eos_token
            first_eos = is_eos.int().argmax(dim=1)
            last = torch.where(is_eos.any(dim=1), s_img + first_eos,
                               torch.full_like(first_eos, s - 1))
            feat = x[torch.arange(b, device=x.device), last]
        else:
            feat = x.mean(dim=1)
        head = params["class_head"]
        logits = feat.float() @ head["kernel"].float() + head["bias"].float()
        if mesh is None:
            loss = F.cross_entropy(logits, class_labels.long())
        else:
            from magma_tpu_torch.parallel.mesh import all_reduce

            n = all_reduce(torch.tensor(float(b), device=logits.device), mesh, "dp")
            loss = F.cross_entropy(logits, class_labels.long(), reduction="sum") / n
        return loss, (new_state, logits)

    @torch.no_grad()
    def forward(self, images, captions, class_labels=None, **kw):
        """(loss, logits): the classification loss and class logits with
        ``class_labels``, else the caption loss and vocabulary logits."""
        if class_labels is None:
            return super().forward(images, captions, **kw)
        dev = self.device
        images = ([torch.as_tensor(i, device=dev).float() for i in images]
                  if isinstance(images, (list, tuple)) else torch.as_tensor(images, device=dev))
        loss, (_, logits) = self.classification_loss_fn(
            self.params, self.state, images, torch.as_tensor(captions, device=dev),
            torch.as_tensor(class_labels, device=dev), train=False)
        return loss, logits


def collate_fn_classification(batch_data: Sequence, seq_len: int = 2048
                              ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """[(img_0, ..., img_k, caption, label), ...] -> ([images_0, ...,
    images_k], captions, labels).  Parity: utils.py:272-282 (the NLVR2
    multi-image collate)."""
    cols = list(zip(*batch_data))
    image_cols, captions, labels = cols[:-2], cols[-2], cols[-1]
    images_list = [np.concatenate(col, axis=0) for col in image_cols]
    captions = np.concatenate([c[:, :seq_len] for c in captions], axis=0)
    return images_list, captions, np.asarray(labels)
