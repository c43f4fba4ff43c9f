"""NF-ResNet50 ("nfresnet50"), the normalizer-free ResNet, in functional
PyTorch.

Port of ``magma_tpu/models/nfnet.py`` (timm's ``nf_resnet50`` without its
head, adaptive average pooling appended; magma/image_encoders.py:31-45):

* a 7x7/2 scaled weight-standardized (WS) conv stem + scaled ReLU, then a
  3x3/2 max pool,
* four stages of bottlenecks (3, 4, 6, 3), widths 256/512/1024/2048,
* every conv WS: the kernel is standardized over its fan-in in fp32 on
  every apply, ``(k - mean) * rsqrt(var * fan_in + 1e-4) * gain``,
* the residual ``shortcut + 0.2 * skipinit_gain * f(x / beta)``, beta
  tracking the expected variance, which resets at each transition block,
  whose shortcut takes the activated input except in stage 1.

Padding is XLA's "SAME" for every k > 1 conv and for the max pool: at
stride 2 on an even input that is (2, 3) for the 7x7 stem and (0, 1) for a
3x3, which PyTorch's symmetric ``padding=`` cannot express, so the input
is padded explicitly (``clip_resnet._same_pads``); the pool pads with -inf.
Conv inputs and kernels are cast to ``compute_dtype`` and the output taken
in fp32; the pooled output is the fp32 mean, cast at the end.  Kernels are
stored OIHW; the tree otherwise matches the JAX package's key for key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from magma_tpu_torch.models.clip_resnet import _pad_same, _same_pads
from magma_tpu_torch.utils import to_dtype

GAMMA_RELU = 1.7139588594436646  # sqrt(2 / (1 - 1/pi))
ALPHA = 0.2


@dataclasses.dataclass(frozen=True)
class NFResNetConfig:
    blocks: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    input_resolution: int = 256
    compute_dtype: object = torch.bfloat16

    @property
    def out_dim(self) -> int:
        return self.width * 32

    @classmethod
    def named(cls, name: str = "nfresnet50", **overrides) -> "NFResNetConfig":
        return cls(**overrides)


def _stride(stage: int, b: int) -> int:
    return (2 if stage > 1 else 1) if b == 0 else 1


def init_params(generator: torch.Generator, cfg: NFResNetConfig,
                device=None) -> Tuple[Dict, Dict]:
    """Returns (params, {}): no normalisation layer, so no batch statistics."""

    def ws(kh, cin, cout):
        return {"kernel": torch.randn((cout, cin, kh, kh), generator=generator,
                                      device=device).mul_((kh * kh * cin) ** -0.5),
                "gain": torch.ones(cout, device=device),
                "bias": torch.zeros(cout, device=device)}

    w = cfg.width
    params: Dict = {"stem": ws(7, 3, w)}
    cin = w
    for stage, n_blocks in enumerate(cfg.blocks, start=1):
        planes = w * 2 ** (stage - 1)
        cout = planes * 4
        blocks: List[Dict] = []
        for b in range(n_blocks):
            bp = {"conv1": ws(1, cin, planes), "conv2": ws(3, planes, planes),
                  "conv3": ws(1, planes, cout),
                  "skipinit_gain": torch.zeros((), device=device)}
            if b == 0 and (_stride(stage, b) > 1 or cin != cout):
                bp["down"] = ws(1, cin, cout)
            blocks.append(bp)
            cin = cout
        params[f"layer{stage}"] = blocks
    return params, {}


def _ws_conv(x: torch.Tensor, p: Dict, stride: int, dtype) -> torch.Tensor:
    """Scaled weight-standardized conv (``nfnet.py:66-82``); fp32 result."""
    k = p["kernel"].float()
    fan_in = k[0].numel()
    mean = k.mean(dim=(1, 2, 3), keepdim=True)
    var = k.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    k = (k - mean) * torch.rsqrt(var * fan_in + 1e-4) * p["gain"].float()[:, None, None, None]
    x = _pad_same(x, k.shape[-1], stride)
    y = F.conv2d(x.to(dtype), k.to(dtype), stride=stride).float()
    return y + p["bias"].float()[None, :, None, None]


def _act(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x) * GAMMA_RELU


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool, "SAME" padding with -inf (``nfnet.py:131-133``)."""
    ph, pw = _same_pads(x.shape[2], 3, 2), _same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def apply(params: Dict, stats: Dict, images: torch.Tensor, cfg: NFResNetConfig,
          *, train: bool = False) -> Tuple[torch.Tensor, Dict]:
    """(b, 3, H, W) images -> ((b, out_dim) pooled features in the compute
    dtype, the stats unchanged)."""
    del train
    cdt = to_dtype(cfg.compute_dtype)
    x = _act(_ws_conv(images.float(), params["stem"], 2, cdt))
    x = _max_pool_same(x)

    expected_var = 1.0
    for stage in range(1, 5):
        for b, bp in enumerate(params[f"layer{stage}"]):
            stride = _stride(stage, b)
            out = _act(x / expected_var ** 0.5)
            if "down" in bp:
                # a transition block: its shortcut takes the activated input
                # except in stage 1, and the expected variance resets
                shortcut = _ws_conv(out if stage > 1 else x, bp["down"], stride, cdt)
                expected_var = 1.0
            else:
                shortcut = x
            h = _act(_ws_conv(out, bp["conv1"], 1, cdt))
            h = _act(_ws_conv(h, bp["conv2"], stride, cdt))
            h = _ws_conv(h, bp["conv3"], 1, cdt)
            x = shortcut + ALPHA * bp["skipinit_gain"].float() * h
            expected_var = expected_var + ALPHA ** 2

    return _act(x).mean(dim=(2, 3)).to(cdt), stats
