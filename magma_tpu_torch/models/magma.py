"""Magma model facade: LM + tokenizer + ImagePrefix + adapters, in PyTorch.

Port of the inference surface of ``magma_tpu/models/magma.py`` (reference
magma/magma.py:29-301): ``Magma(config, seed=..., device=...)``,
``preprocess_inputs``, ``embed``, ``generate`` and ``from_checkpoint``.
Parameters live in ``self.params = {"lm": ..., "image_prefix": ...}`` and
the vision tower's BN statistics in ``self.state``, as in the JAX package.
Everything runs on ``device``, the GPU unless the caller asks for the CPU;
nothing moves to the CPU when a GPU is asked for and missing.
``quantize_for_serving(bits=8)`` gives the int8 serving path and
``quantize_for_serving(bits=4)`` the int4 one.  ``trainable_mask``,
``loss_fn`` and ``pack_for_serving`` are not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from magma_tpu_torch.config import MultimodalConfig
from magma_tpu_torch.models import gptj, image_prefix as ip_mod
from magma_tpu_torch.models.adapters import AdapterSpec
from magma_tpu_torch.ops.sampling import generate_tokens, strip_after_eos
from magma_tpu_torch.tokenizer import get_tokenizer
from magma_tpu_torch.utils import to_dtype


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
            self.params = {
                "lm": gptj.init_params(g, self.lm_config, self.device),
                "image_prefix": ip_params,
            }
            self.state = {"image_prefix": ip_stats}

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
                                                  x.long()))
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
    ):
        """KV-cached sampling.  Parity: magma.py:214-236 + sampling.py.

        The prompt pads to a multiple of 64 as in the JAX package
        (``prompt_len`` masks the padding), then ``generate_tokens`` runs
        one prefill and the decode loop.  ``prompt_len`` (optional, (b,))
        gives per-row true lengths of right-padded prompts; ``timing``
        receives the stage times (see ``generate_tokens``) and ``steps``.
        Returns decoded strings, or the (b, max_steps) token array with
        ``decode=False``."""
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
        tokens, steps = generate_tokens(
            self.lm_config, self.params["lm"], embeddings, generator,
            max_steps=max_steps, temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), eos_token=self.eos_token, prompt_len=prompt_len,
            timing=timing,
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
        """Load a reference-named torch checkpoint
        (``mp_rank_00_model_states.pt``; ``sd["module"]`` is unwrapped).
        Parity: magma/magma.py:278-301."""
        from magma_tpu_torch.convert import load_torch_checkpoint

        model = cls(config_path, device=device, init_weights=False)
        model.params, model.state = load_torch_checkpoint(
            str(checkpoint_path), model.lm_config, model.prefix_config, model.device)
        return model
