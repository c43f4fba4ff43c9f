"""Magma model facade: LM + tokenizer + ImagePrefix + adapters, in PyTorch.

Port of the inference surface of ``magma_tpu/models/magma.py`` (reference
magma/magma.py:29-301): ``Magma(config, seed=..., device=...)``,
``preprocess_inputs``, ``embed``, ``generate`` and ``from_checkpoint``.
Parameters live in ``self.params = {"lm": ..., "image_prefix": ...}`` and
the vision tower's BN statistics in ``self.state``, as in the JAX package.
Everything runs on ``device``, the GPU unless the caller asks for the CPU;
nothing moves to the CPU when a GPU is asked for and missing.
``quantize_for_serving(bits=8)`` gives the int8 serving path and
``quantize_for_serving(bits=4)`` the int4 one.  Training: ``trainable_mask``
(the freezing policy), ``loss_fn`` (differentiable with torch.autograd)
and ``forward``; ``train_lm_int8`` quantizes the frozen LM into the QLoRA
layout right after init.  ``pack_for_serving`` is not ported.

``mesh`` (``parallel/``; the JAX package's ``sp_mesh``, which the port
needs for tp and dp as well, having no GSPMD): the Trainer sets it to its
mesh, and a caller that holds this rank's shards of ``params`` sets it
too.  ``embed``, ``generate`` and ``loss_fn`` then run the LM's parallel
layers over it: the vocab-sharded embedding, the sequence-sharded ring
(``loss_fn`` takes the rank's slice of the sequence), the loss summed
over the ranks' positions and divided by the count over "dp" and "sp",
and the image tower's batch statistics over "dp".
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from magma_tpu_torch.config import MultimodalConfig
from magma_tpu_torch.models import gptj, image_prefix as ip_mod
from magma_tpu_torch.models.adapters import AdapterSpec
from magma_tpu_torch.ops.sampling import generate_tokens, generate_tokens_split, strip_after_eos
from magma_tpu_torch.tokenizer import get_tokenizer
from magma_tpu_torch.training.labels import (IGNORE, _nll, build_labels, causal_lm_loss,
                                             causal_lm_loss_chunked, chunked_nll)
from magma_tpu_torch.utils import to_dtype, tree_map, tree_paths

# b·s (after padding to 64) above which generate takes the split path
SPLIT_ABOVE = 8192


def build_lm_config(config: MultimodalConfig) -> gptj.GPTJConfig:
    """MultimodalConfig -> GPTJConfig, wiring adapter_config
    (magma/magma.py:73-90) into the block definition."""
    ac = config.adapter_config or {}
    kwargs = dict(
        compute_dtype=to_dtype(config.compute_dtype),
        # the frozen LM is stored in frozen_dtype; adapters keep param_dtype
        param_dtype=to_dtype(config.frozen_dtype if config.freeze_lm
                             else config.param_dtype),
        adapter_param_dtype=to_dtype(config.param_dtype),
        attention_impl=config.attention_impl,
        remat=config.remat,
        mlp_adapter=AdapterSpec.from_dict(ac["mlp"]) if ac.get("mlp") else None,
        attn_adapter=(AdapterSpec.from_dict(ac["attention"])
                      if ac.get("attention") else None),
    )
    kwargs.update(config.lm_overrides or {})
    return gptj.GPTJConfig.gptj_6b(**kwargs)


def build_prefix_config(config: MultimodalConfig,
                        lm_cfg: gptj.GPTJConfig) -> ip_mod.ImagePrefixConfig:
    overrides = config.encoder_overrides or {}
    return ip_mod.ImagePrefixConfig(
        encoder_name=config.encoder_name,
        out_dim=lm_cfg.d_model,
        image_seq_len=config.image_seq_len,
        dropout_prob=config.image_embed_dropout_prob,
        use_layernorm=config.use_image_embed_layernorm,
        encoder_overrides=tuple(sorted(overrides.items())) or None,
        compute_dtype=to_dtype(config.compute_dtype),
    )


class Magma:
    """Multimodal VLM facade.  See module docstring."""

    def __init__(
        self,
        config: Union[str, Path, MultimodalConfig],
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
        init_weights: bool = True,
    ):
        if isinstance(config, (str, Path)):
            config = MultimodalConfig.from_yml(config)
        if not isinstance(config, MultimodalConfig):
            raise TypeError(f"config must be a path or MultimodalConfig, got {type(config)}")
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Magma was asked for {self.device}, but CUDA is not "
                               "available; pass device='cpu' to run on the CPU")

        self.lm_config = build_lm_config(config)
        self.seq_len = min(config.seq_len or self.lm_config.max_seq_len,
                           self.lm_config.max_seq_len)
        self.tokenizer = get_tokenizer(
            "gpt2", sequence_length=self.seq_len,
            strict=getattr(config, "strict_tokenizer", False),
        )
        self.image_token = self.tokenizer.cls_token_id
        self.eos_token = self.tokenizer.eos_token_id

        self.prefix_config = build_prefix_config(config, self.lm_config)
        self.image_prefix_seq_len = self.prefix_config.out_seq_len
        # the process mesh the params are sharded over (module docstring)
        self.mesh = None

        from magma_tpu_torch.data.transforms import get_transforms

        self.transforms = get_transforms(
            config.image_size, config.encoder_name,
            input_resolution=self.prefix_config.input_resolution, device=self.device,
        )

        self.params = None
        self.state = None
        if init_weights:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            ip_params, ip_stats = ip_mod.init_params(g, self.prefix_config, self.device)
            lm = gptj.init_params(g, self.lm_config, self.device)
            if config.train_lm_int8:
                # QLoRA: the frozen LM in int8 with separate, differentiable
                # o / fc_out products and bf16 adapters
                if not config.freeze_lm:
                    raise ValueError("train_lm_int8 requires a frozen LM (freeze_lm)")
                lm = gptj.quantize_lm_params(lm, fuse_out_proj=False)
            self.params = {"lm": lm, "image_prefix": ip_params}
            self.state = {"image_prefix": ip_stats}

    # ------------------------------------------------------------------
    # Freezing policy
    # ------------------------------------------------------------------
    def trainable_mask(self):
        """A tree of bools over ``self.params``, True = trainable: the LM
        frozen (unless not ``freeze_lm``) except its adapters, the image
        prefix's projection and LN trainable, its encoder unless
        ``freeze_img_encoder`` (``magma.py:173-190``)."""
        cfg = self.config

        def trainable(path: str) -> bool:
            if path.startswith("lm"):
                return "adapter" in path or not cfg.freeze_lm
            if path.startswith("image_prefix/enc"):
                return not cfg.freeze_img_encoder
            return True

        return tree_map(lambda _, path: trainable(path), self.params, tree_paths(self.params))

    # ------------------------------------------------------------------
    # Inference API
    # ------------------------------------------------------------------
    def preprocess_inputs(self, input_list: list, embed: bool = True):
        """Strings -> token arrays; ImageInputs and PIL images -> transformed
        image tensors; optionally embed.  Parity: magma/magma.py:176-193."""
        from magma_tpu_torch.data.image_input import ImageInput

        out = list(input_list)
        for i, inp in enumerate(out):
            if isinstance(inp, str):
                out[i] = self.tokenizer.encode(inp)
            elif isinstance(inp, ImageInput):
                out[i] = inp.get_transformed_image(transform_fn=self.transforms)
            elif isinstance(inp, (np.ndarray, torch.Tensor)):
                pass  # already a tensor
            elif type(inp).__module__.startswith("PIL."):
                out[i] = self.transforms(inp)
            else:
                raise TypeError(f"Invalid input type:{type(inp)}")
        if embed:
            return self.embed(out)
        return out

    @torch.no_grad()
    def embed(self, inputs: List) -> torch.Tensor:
        """2-D token arrays and 4-D image arrays -> one (b, s, d) embedding
        sequence, order preserved.  Parity: magma.py:195-212."""
        emb_list = []
        for x in inputs:
            x = torch.as_tensor(x, device=self.device)
            if x.dim() == 2:
                emb_list.append(gptj.embed_tokens(self.lm_config, self.params["lm"],
                                                  x.long(), self.mesh))
            elif x.dim() == 4:
                emb, _ = ip_mod.apply(self.params["image_prefix"],
                                      self.state["image_prefix"], x.float(),
                                      self.prefix_config)
                emb_list.append(emb)
            else:
                raise ValueError(f"Expected 2d or 4d tensor, got {x.dim()}d")
        return torch.cat(emb_list, dim=1)

    @torch.no_grad()
    def generate(
        self,
        embeddings: torch.Tensor,
        max_steps: int = 100,
        temperature: float = 0.7,
        top_k: int = 0,
        top_p: float = 0.9,
        decode: bool = True,
        generator: Optional[torch.Generator] = None,
        prompt_len=None,
        timing: Optional[dict] = None,
        mesh=None,
    ):
        """KV-cached sampling.  Parity: magma.py:214-236 + sampling.py.

        The prompt pads to a multiple of 64 as in the JAX package
        (``prompt_len`` masks the padding), then ``generate_tokens`` runs
        one prefill and the decode loop; above 8192 padded positions (b·s)
        ``generate_tokens_split`` prefills in 512-position chunks and
        decodes in windows of 8 (``magma.py:296-298``), which bounds the
        prefill's activations.  ``prompt_len`` (optional, (b,))
        gives per-row true lengths of right-padded prompts; ``timing``
        receives the stage times (see ``generate_tokens``) and ``steps``.
        ``mesh`` (default ``self.mesh``): ``generate_tokens`` over it, never
        the split path (``magma.py:256-296``): the sequence-sharded cache
        with ``attention_impl="ring"``, tensor parallelism over sharded
        params.  Returns decoded strings, or the (b, max_steps) token array
        with ``decode=False``."""
        embeddings = torch.as_tensor(embeddings, device=self.device)
        s = embeddings.shape[1]
        pad = (-s) % 64
        if pad:
            embeddings = torch.nn.functional.pad(embeddings, (0, 0, 0, pad))
        if prompt_len is None:
            prompt_len = s
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.seed()
        mesh = self.mesh if mesh is None else mesh
        gen, extra = generate_tokens, {}
        if mesh is not None:
            extra = dict(mesh=mesh)
        elif embeddings.shape[0] * embeddings.shape[1] > SPLIT_ABOVE:
            gen, extra = generate_tokens_split, dict(window=8, prefill_chunk=512)
        tokens, steps = gen(
            self.lm_config, self.params["lm"], embeddings, generator,
            max_steps=max_steps, temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), eos_token=self.eos_token, prompt_len=prompt_len,
            timing=timing, **extra,
        )
        if timing is not None:
            timing["steps"] = steps
        tokens = tokens.cpu().numpy()
        if not decode:
            return tokens
        return [
            self.tokenizer._decode_ids(strip_after_eos(row, self.eos_token, self.image_token))
            for row in tokens
        ]

    # ------------------------------------------------------------------
    # Training forward
    # ------------------------------------------------------------------
    def loss_fn(self, params, state, images: Optional[torch.Tensor], captions: torch.Tensor, *,
                train: bool = True, generator: Optional[torch.Generator] = None,
                input_embeddings: Optional[torch.Tensor] = None, return_logits: bool = False):
        """The captioning loss, differentiable in the params that require
        grad.  Returns (loss, (new_state, logits or None)).  Parity:
        magma/magma.py:238-276.  Training takes the chunked loss (no
        logits); ``return_logits=True`` the full fp32 logits.  ``generator``
        draws the ImagePrefix dropout bits when ``train``."""
        if captions is None:
            raise ValueError("Must provide captions in training")
        if (images is None) == (input_embeddings is None):
            raise ValueError("Pass in either images, or input embeddings, not both.")
        if captions.shape[1] != self.seq_len:
            raise ValueError(f"in training, captions should be padded to sequence length "
                             f"({self.seq_len}), but are length {captions.shape[1]}")
        mesh = self.mesh
        new_state = state
        if input_embeddings is None:
            input_embeddings, new_ip_stats = ip_mod.apply(
                params["image_prefix"], state["image_prefix"], images, self.prefix_config,
                train=train, generator=generator, mesh=mesh)
            new_state = {"image_prefix": new_ip_stats}
        s_img = input_embeddings.shape[1]
        labels = build_labels(s_img, captions, self.eos_token)
        word_embeds = gptj.embed_tokens(self.lm_config, params["lm"], captions.long(), mesh)
        # drop the caption's right padding so the total stays seq_len
        embeds = torch.cat([input_embeddings, word_embeds[:, :self.seq_len - s_img]], dim=1)
        if mesh is None:
            if return_logits:
                logits, _ = gptj.forward(self.lm_config, params["lm"], embeds)
                return (causal_lm_loss(logits, labels, self.lm_config.vocab_size),
                        (new_state, logits))
            hidden, _ = gptj.forward(self.lm_config, params["lm"], embeds, return_hidden=True)
            loss = causal_lm_loss_chunked(self.lm_config, params["lm"], hidden, labels)
            return loss, (new_state, None)
        return self._mesh_loss(params, embeds, labels, mesh, return_logits, new_state)

    def _mesh_loss(self, params, embeds, labels, mesh, return_logits, new_state):
        """The loss over a mesh: this rank's share of the global NLL sum
        divided by the global count of valid positions (over "dp" and "sp"),
        so the ranks' losses (and gradients) sum to the JAX package's global
        mean (``labels.py:97-114``).  With ring attention the rank runs its
        slice of the sequence and the next-token targets of that slice."""
        from magma_tpu_torch.parallel.mesh import all_reduce

        cfg = self.lm_config
        targets = labels[:, 1:]
        if cfg.attention_impl == "ring":
            if return_logits:
                raise ValueError("ring attention gives each rank its slice of the sequence; "
                                 "return_logits needs the whole")
            n, i = mesh.size(cfg.sp_axis), mesh.axis_index(cfg.sp_axis)
            if embeds.shape[1] % n:
                raise ValueError(f"sequence {embeds.shape[1]} is not divisible by "
                                 f"{cfg.sp_axis}={n}")
            s_loc = embeds.shape[1] // n
            embeds = embeds[:, i * s_loc:(i + 1) * s_loc]
            targets = torch.nn.functional.pad(targets, (0, 1), value=IGNORE)
            targets = targets[:, i * s_loc:(i + 1) * s_loc]
        hidden, _ = gptj.forward(cfg, params["lm"], embeds, return_hidden=True, mesh=mesh)
        if cfg.attention_impl != "ring":
            hidden = hidden[:, :-1]
        logits = None
        if return_logits:
            logits = gptj.lm_head(cfg, params["lm"], hidden, mesh)
            nll, count = _nll(logits, targets, cfg.vocab_size)
        else:
            nll, count = chunked_nll(cfg, params["lm"], hidden, targets, mesh=mesh)
        count = all_reduce(count.clone(), mesh, ("dp", "sp"))
        return nll / torch.clamp(count, min=1), (new_state, logits)

    @torch.no_grad()
    def forward(self, images, captions, input_embeddings=None):
        """Eval/debug: (loss, fp32 logits) with ``train=False``."""
        loss, (_, logits) = self.loss_fn(self.params, self.state, images, captions, train=False,
                                         input_embeddings=input_embeddings, return_logits=True)
        return loss, logits

    # ------------------------------------------------------------------
    # Serving transforms
    # ------------------------------------------------------------------
    @torch.no_grad()
    def quantize_for_serving(self, bits: int = 8) -> "Magma":
        """Quantize the frozen LM weight-only for serving and fold the
        vision tower's BN (``magma.py:386-408``).  Irreversible on this
        instance: the full-precision LM weights are freed.  ``bits=8`` is
        the int8 layout of ``gptj.quantize_lm_params``, whose products run
        as the K2a/K2b/K4a/K5 kernels on the card; ``bits=4`` the int4
        layout of ``gptj.quantize_lm_params_int4`` (K3, K4b, K6, and K2a
        for the int8 head), which must start from full precision."""
        if bits == 8:
            self.params["lm"] = gptj.quantize_lm_params(self.params["lm"])
        elif bits == 4:
            self.params["lm"] = gptj.quantize_lm_params_int4(self.params["lm"])
        else:
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        self._fold_vision()
        return self

    def _fold_vision(self):
        """BN folded into the tower's convs, bf16 projection
        (``image_prefix.fold_for_serving``).  Idempotent."""
        self.params["image_prefix"] = ip_mod.fold_for_serving(
            self.params["image_prefix"], self.state["image_prefix"], self.prefix_config)

    # ------------------------------------------------------------------
    # Checkpoint
    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, config_path, checkpoint_path,
                        device: Union[str, torch.device] = "cuda") -> "Magma":
        """Load a checkpoint (``magma.py:437-470``).  A directory is one the
        port's ``save_checkpoint`` wrote (``Trainer.save``, the converter
        CLI): a save root or a step directory, restored by
        ``training.checkpoint.restore_params`` into the template this
        config builds (the int8 QLoRA layout with ``train_lm_int8``), in
        place on ``device``.  A file is a reference-named torch checkpoint
        (``mp_rank_00_model_states.pt``; ``sd["module"]`` is unwrapped;
        parity: magma/magma.py:278-301)."""
        path = Path(checkpoint_path)
        if path.is_dir():
            from magma_tpu_torch.training.checkpoint import restore_params

            model = cls(config_path, device=device)
            model.params, model.state = restore_params(str(path), model.params, model.state)
            return model
        from magma_tpu_torch.convert import load_torch_checkpoint

        model = cls(config_path, device=device, init_weights=False)
        model.params, model.state = load_torch_checkpoint(
            str(path), model.lm_config, model.prefix_config, model.device)
        return model
