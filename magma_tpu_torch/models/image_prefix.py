"""ImagePrefix: image batch -> sequence of LM-dimension embeddings.

Port of ``magma_tpu/models/image_prefix.py`` (reference
magma/image_prefix.py:24-109, the encoder factory
magma/image_encoders.py:79-91):

* a spatial tower (the CLIP ResNets) emits (b, tokens, enc_dim); one
  linear projects enc_dim -> lm_dim;
* a pooled tower (the CLIP ViT-B/32 "clip", "nfresnet50") emits
  (b, enc_dim); the linear projects to lm_dim * image_seq_len and the
  result is reshaped to (b, image_seq_len, lm_dim);
* dropout (identity at inference; in training the JAX package's keep /
  rescale rule with bits from a ``torch.Generator``) and an optional fp32
  LayerNorm follow, in that order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from magma_tpu_torch.models import clip_resnet, clip_vit, nfnet
from magma_tpu_torch.utils import to_dtype

# name -> (module, its config class, pooled?)
_ENCODERS = {
    "clip": (clip_vit, clip_vit.ClipViTConfig, True),
    "clip_resnet": (clip_resnet, clip_resnet.ClipResNetConfig, False),
    "clip_resnet_large": (clip_resnet, clip_resnet.ClipResNetConfig, False),
    "clip_rn50": (clip_resnet, clip_resnet.ClipResNetConfig, False),
    "nfresnet50": (nfnet, nfnet.NFResNetConfig, True),
}


def get_encoder(name: str, overrides: Optional[dict] = None):
    """Encoder registry.  Returns (module, config, pooled)."""
    if name not in _ENCODERS:
        raise ValueError(f"image encoder {name} not recognized")
    module, config_cls, pooled = _ENCODERS[name]
    return module, config_cls.named(name, **dict(overrides or {})), pooled


@dataclasses.dataclass(frozen=True)
class ImagePrefixConfig:
    encoder_name: str = "clip_resnet_large"
    out_dim: int = 4096            # LM hidden size
    image_seq_len: int = 2         # pooled towers only
    dropout_prob: float = 0.0
    use_layernorm: bool = False
    encoder_overrides: Optional[tuple] = None  # tuple(sorted(dict.items()))
    compute_dtype: object = torch.bfloat16

    @property
    def encoder(self):
        ov = dict(self.encoder_overrides) if self.encoder_overrides else {}
        return get_encoder(self.encoder_name, ov)

    @property
    def out_seq_len(self) -> int:
        _, enc_cfg, pooled = self.encoder
        return self.image_seq_len if pooled else enc_cfg.out_tokens

    @property
    def input_resolution(self) -> int:
        return self.encoder[1].input_resolution


def init_params(generator: torch.Generator, cfg: ImagePrefixConfig,
                device=None) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats), fp32."""
    module, enc_cfg, pooled = cfg.encoder
    enc_params, enc_stats = module.init_params(generator, enc_cfg, device)
    enc_dim = enc_cfg.out_dim
    proj_out = cfg.out_dim * cfg.image_seq_len if pooled else cfg.out_dim
    params = {
        "enc": enc_params,
        "proj": {
            "kernel": torch.randn((enc_dim, proj_out), generator=generator,
                                  device=device).mul_(enc_dim ** -0.5),
            "bias": torch.zeros(proj_out, device=device),
        },
    }
    if cfg.use_layernorm:
        params["ln"] = {"scale": torch.ones(cfg.out_dim, device=device),
                        "bias": torch.zeros(cfg.out_dim, device=device)}
    return params, {"enc": enc_stats}


def fold_for_serving(params: Dict, stats: Dict, cfg: ImagePrefixConfig) -> Dict:
    """Serving transform (``image_prefix.py:105-121``): fold a CLIP
    ResNet's inference BN into its convs (``clip_resnet.fold_bn``; the
    pooled towers have no BN) and store the projection in bf16.  Returns a
    new params tree; ``apply`` takes it as it is (the stats pass through).
    Idempotent."""
    module, enc_cfg, _ = cfg.encoder
    out = dict(params)
    if module is clip_resnet and not clip_resnet.is_folded(params["enc"]):
        out["enc"] = module.fold_bn(params["enc"], stats["enc"], enc_cfg)
    out["proj"] = {k: v.to(torch.bfloat16) for k, v in params["proj"].items()}
    return out


def apply(params: Dict, stats: Dict, images: torch.Tensor, cfg: ImagePrefixConfig,
          *, train: bool = False, generator: Optional[torch.Generator] = None, mesh=None
          ) -> Tuple[torch.Tensor, Dict]:
    """(b, 3, H, W) images -> ((b, out_seq_len, out_dim) embeddings in the
    compute dtype, new batch stats).  ``train`` runs the tower's training
    BN and, with ``dropout_prob`` > 0, dropout: an element is kept with
    probability 1 - p and scaled by 1 / (1 - p) (``image_prefix.py:148-151``),
    the bits drawn from ``generator`` (JAX's bits cannot be reproduced).
    ``mesh``: ``images`` are this rank's "dp" shard, and a CLIP ResNet's
    training batch statistics are taken over the whole batch, as GSPMD
    takes them over the dp-sharded batch."""
    module, enc_cfg, pooled = cfg.encoder
    cdt = to_dtype(cfg.compute_dtype)
    # only the CLIP ResNets keep batch statistics
    kw = {"mesh": mesh} if mesh is not None and module is clip_resnet else {}
    feats, enc_stats = module.apply(params["enc"], stats["enc"], images, enc_cfg, train=train,
                                    **kw)
    x = feats.to(cdt) @ params["proj"]["kernel"].to(cdt) + params["proj"]["bias"].to(cdt)
    if pooled:
        x = x.reshape(x.shape[0], cfg.image_seq_len, cfg.out_dim)
    if train and cfg.dropout_prob > 0.0:
        if generator is None:
            raise ValueError("dropout in training needs a generator")
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - cfg.dropout_prob
        x = torch.where(keep, x / (1.0 - cfg.dropout_prob), 0.0).to(cdt)
    if "ln" in params:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        x32 = (x32 - mean) * torch.rsqrt(var + 1e-5)
        x = (x32 * params["ln"]["scale"].float() + params["ln"]["bias"].float()).to(cdt)
    return x, {"enc": enc_stats}
