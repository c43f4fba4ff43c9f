"""CLIP's ViT-B/32 visual tower ("clip"), in functional PyTorch.

Port of ``magma_tpu/models/clip_vit.py`` (the reference's
``clip.load("ViT-B/32").visual``, magma/image_encoders.py:62):

* a 32x32 patch conv without bias -> 7 x 7 = 49 patches at 224 px,
* a learned class token and position embedding, added in fp32, then
  ``ln_pre``,
* 12 pre-LN blocks of width 768, 12 heads, MLP 4x with QuickGELU
  (x * sigmoid(1.702 x)), LN statistics in fp32 (population variance),
* ``ln_post`` over the class token, then the 768 -> 512 ``proj``.

The tower is pooled: it returns (b, 512).  Matmuls run in
``compute_dtype``; attention over the 50 tokens is the plain
``xla_attention`` (bf16 operands, fp32 scores), as in the JAX package,
which runs it as XLA, not as a Pallas kernel.  The patch kernel is stored
OIHW, the rest key for key as the JAX package's tree (blocks stacked on a
leading layer axis).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from magma_tpu_torch.ops.attention import xla_attention
from magma_tpu_torch.utils import to_dtype


@dataclasses.dataclass(frozen=True)
class ClipViTConfig:
    input_resolution: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512  # the projection's output
    ln_eps: float = 1e-5
    compute_dtype: object = torch.bfloat16

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def out_dim(self) -> int:
        return self.embed_dim

    @classmethod
    def named(cls, name: str = "clip", **overrides) -> "ClipViTConfig":
        return cls(**overrides)


def init_params(generator: torch.Generator, cfg: ClipViTConfig,
                device=None) -> Tuple[Dict, Dict]:
    """Returns (params, {}): the tower keeps no batch statistics."""
    W, L, P = cfg.width, cfg.layers, cfg.patch_size

    def normal(shape, s=0.02):
        return torch.randn(shape, generator=generator, device=device).mul_(s)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    std = W ** -0.5
    params = {
        "patch_embed": normal((W, 3, P, P), (3 * P * P) ** -0.5),
        "class_token": normal((W,), std),
        "pos_embed": normal((cfg.seq_len, W), std),
        "ln_pre": {"scale": ones(W), "bias": zeros(W)},
        "blocks": {
            "ln_1": {"scale": ones(L, W), "bias": zeros(L, W)},
            "attn": {
                "qkv": {"kernel": normal((L, W, 3 * W)), "bias": zeros(L, 3 * W)},
                "out": {"kernel": normal((L, W, W)), "bias": zeros(L, W)},
            },
            "ln_2": {"scale": ones(L, W), "bias": zeros(L, W)},
            "mlp": {
                "fc": {"kernel": normal((L, W, 4 * W)), "bias": zeros(L, 4 * W)},
                "proj": {"kernel": normal((L, 4 * W, W)), "bias": zeros(L, W)},
            },
        },
        "ln_post": {"scale": ones(W), "bias": zeros(W)},
        "proj": normal((W, cfg.embed_dim), std),
    }
    return params, {}


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm (``clip_vit.py:97-101``): population variance."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _linear(x: torch.Tensor, p: Dict, i: int, cdt) -> torch.Tensor:
    return x @ p["kernel"][i].to(cdt) + p["bias"][i].to(cdt)


def apply(params: Dict, stats: Dict, images: torch.Tensor, cfg: ClipViTConfig,
          *, train: bool = False) -> Tuple[torch.Tensor, Dict]:
    """(b, 3, H, W) images -> ((b, embed_dim) pooled features in the compute
    dtype, the stats unchanged).  ``train`` changes nothing: the tower has
    no batch-dependent state."""
    del train
    cdt = to_dtype(cfg.compute_dtype)
    b = images.shape[0]
    x = F.conv2d(images.to(cdt), params["patch_embed"].to(cdt), stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)  # (b, grid², W), patches row-major as NHWC
    cls = params["class_token"].float().expand(b, 1, cfg.width)
    x = torch.cat([cls, x.float()], dim=1) + params["pos_embed"].float()
    x = _ln(x, params["ln_pre"]["scale"], params["ln_pre"]["bias"], cfg.ln_eps).to(cdt)

    h, hd = cfg.heads, cfg.head_dim
    s = x.shape[1]
    bp = params["blocks"]
    for i in range(cfg.layers):
        u = _ln(x, bp["ln_1"]["scale"][i], bp["ln_1"]["bias"][i], cfg.ln_eps).to(cdt)
        q, k, v = _linear(u, bp["attn"]["qkv"], i, cdt).split(cfg.width, dim=-1)
        a = xla_attention(q.reshape(b, s, h, hd), k.reshape(b, s, h, hd),
                          v.reshape(b, s, h, hd), scale=hd ** -0.5, causal=False)
        x = x + _linear(a.reshape(b, s, cfg.width), bp["attn"]["out"], i, cdt)
        u = _ln(x, bp["ln_2"]["scale"][i], bp["ln_2"]["bias"][i], cfg.ln_eps).to(cdt)
        m = _linear(u, bp["mlp"]["fc"], i, cdt)
        m = m * torch.sigmoid(1.702 * m)
        x = x + _linear(m, bp["mlp"]["proj"], i, cdt)

    pooled = _ln(x[:, 0], params["ln_post"]["scale"], params["ln_post"]["bias"],
                 cfg.ln_eps).to(cdt)
    return pooled @ params["proj"].to(cdt), stats
