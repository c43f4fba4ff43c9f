"""ImagePrefix: image batch -> sequence of LM-dimension embeddings.

Port of the spatial-encoder path of ``magma_tpu/models/image_prefix.py``
(reference magma/image_prefix.py:24-109): a CLIP ResNet emits
(b, tokens, enc_dim); one linear projects enc_dim -> lm_dim; dropout
(identity at inference) and an optional LayerNorm follow.  The pooled
towers ("clip" ViT, "nfresnet50") are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from magma_tpu_torch.models import clip_resnet
from magma_tpu_torch.utils import to_dtype

_CLIP_RESNETS = ("clip_resnet", "clip_resnet_large", "clip_rn50")
_NOT_PORTED = ("clip", "nfresnet50")


def get_encoder(name: str, overrides: Optional[dict] = None):
    """Encoder registry.  Returns (module, config, pooled)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"image encoder {name!r} is not ported yet")
    if name not in _CLIP_RESNETS:
        raise ValueError(f"image encoder {name} not recognized")
    return clip_resnet, clip_resnet.ClipResNetConfig.named(name, **dict(overrides or {})), False


@dataclasses.dataclass(frozen=True)
class ImagePrefixConfig:
    encoder_name: str = "clip_resnet_large"
    out_dim: int = 4096            # LM hidden size
    use_layernorm: bool = False
    encoder_overrides: Optional[tuple] = None  # tuple(sorted(dict.items()))
    compute_dtype: object = torch.bfloat16

    @property
    def encoder(self):
        ov = dict(self.encoder_overrides) if self.encoder_overrides else {}
        return get_encoder(self.encoder_name, ov)

    @property
    def out_seq_len(self) -> int:
        return self.encoder[1].out_tokens

    @property
    def input_resolution(self) -> int:
        return self.encoder[1].input_resolution


def init_params(generator: torch.Generator, cfg: ImagePrefixConfig,
                device=None) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats), fp32."""
    module, enc_cfg, _ = cfg.encoder
    enc_params, enc_stats = module.init_params(generator, enc_cfg, device)
    enc_dim = enc_cfg.out_dim
    params = {
        "enc": enc_params,
        "proj": {
            "kernel": torch.randn((enc_dim, cfg.out_dim), generator=generator,
                                  device=device).mul_(enc_dim ** -0.5),
            "bias": torch.zeros(cfg.out_dim, device=device),
        },
    }
    if cfg.use_layernorm:
        params["ln"] = {"scale": torch.ones(cfg.out_dim, device=device),
                        "bias": torch.zeros(cfg.out_dim, device=device)}
    return params, {"enc": enc_stats}


def fold_for_serving(params: Dict, stats: Dict, cfg: ImagePrefixConfig) -> Dict:
    """Serving transform (``image_prefix.py:105-121``): fold the tower's
    inference BN into its convs (``clip_resnet.fold_bn``) and store the
    projection in bf16.  Returns a new params tree; ``apply`` takes it as
    it is (the stats pass through).  Idempotent."""
    module, enc_cfg, _ = cfg.encoder
    out = dict(params)
    if not module.is_folded(params["enc"]):
        out["enc"] = module.fold_bn(params["enc"], stats["enc"], enc_cfg)
    out["proj"] = {k: v.to(torch.bfloat16) for k, v in params["proj"].items()}
    return out


def apply(params: Dict, stats: Dict, images: torch.Tensor, cfg: ImagePrefixConfig,
          *, train: bool = False) -> Tuple[torch.Tensor, Dict]:
    """(b, 3, H, W) images -> ((b, out_seq_len, out_dim) embeddings in the
    compute dtype, batch stats).  Inference only: dropout is the identity."""
    if train:
        raise NotImplementedError("the port's ImagePrefix has no training mode yet")
    module, enc_cfg, _ = cfg.encoder
    cdt = to_dtype(cfg.compute_dtype)
    feats, enc_stats = module.apply(params["enc"], stats["enc"], images, enc_cfg)
    x = feats.to(cdt) @ params["proj"]["kernel"].to(cdt) + params["proj"]["bias"].to(cdt)
    if "ln" in params:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        x32 = (x32 - mean) * torch.rsqrt(var + 1e-5)
        x = (x32 * params["ln"]["scale"].float() + params["ln"]["bias"].float()).to(cdt)
    return x, {"enc": enc_stats}
