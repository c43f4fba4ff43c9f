"""CLIP's ModifiedResNet visual tower, inference mode, in functional PyTorch.

Port of ``magma_tpu/models/clip_resnet.py`` (the torch CLIP ResNets the
reference loads via ``clip.load``, magma/image_encoders.py:48-76): a 3-conv
stem with BN + ReLU and a 2x2 average pool, four stages of bottlenecks with
anti-aliased (average-pool) downsampling, and the attention-pool head
replaced by flattening the spatial map into tokens.

Variants:                width  blocks          out_dim  input  tokens
  RN50  ("clip_rn50")      64  (3, 4, 6, 3)      2048     224     49
  RN50x4 ("clip_resnet")   80  (4, 6, 10, 6)     2560     288     81
  RN50x16 ("clip_resnet_large") 96 (6, 8, 18, 8) 3072     384    144

Layout: images are NCHW at the API and inside; conv kernels are stored
OIHW (torch's and the reference checkpoint's layout, where the JAX package
stores HWIO).  The parameter and batch-stat trees otherwise match the JAX
package's key for key.

Numerics follow the JAX package, not torchvision: a 3x3 conv pads "SAME",
which at stride 2 on an even input is (0, 1), not (1, 1); conv inputs and
kernels are cast to ``compute_dtype`` and the output is taken in fp32; BN
uses the running statistics.  ``fold_bn`` makes the serving copy whose
tower runs bf16 end to end.  The training mode is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from magma_tpu_torch.utils import to_dtype

VARIANTS = {
    "clip_rn50": dict(width=64, blocks=(3, 4, 6, 3), input_resolution=224),
    "clip_resnet": dict(width=80, blocks=(4, 6, 10, 6), input_resolution=288),
    "clip_resnet_large": dict(width=96, blocks=(6, 8, 18, 8), input_resolution=384),
}
EXPANSION = 4


@dataclasses.dataclass(frozen=True)
class ClipResNetConfig:
    width: int = 96
    blocks: Tuple[int, ...] = (6, 8, 18, 8)
    input_resolution: int = 384
    compute_dtype: object = torch.bfloat16  # a torch dtype or its name
    bn_eps: float = 1e-5

    @classmethod
    def named(cls, name: str, **overrides) -> "ClipResNetConfig":
        base = dict(VARIANTS[name])
        base.update(overrides)
        return cls(**base)

    @property
    def out_dim(self) -> int:
        return self.width * 32  # width * 8 planes * expansion 4

    @property
    def out_tokens(self) -> int:
        return (self.input_resolution // 32) ** 2


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ClipResNetConfig,
                device=None) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats); He-init OIHW kernels, identity BN."""

    def conv(kh, cin, cout):
        std = (2.0 / (kh * kh * cin)) ** 0.5
        return torch.randn((cout, cin, kh, kh), generator=generator, device=device,
                           dtype=torch.float32).mul_(std)

    def bn(c):
        return (
            {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)},
        )

    w = cfg.width
    params: Dict = {"stem": {}}
    stats: Dict = {"stem": {}}
    stem_chans = [(3, w // 2), (w // 2, w // 2), (w // 2, w)]
    for i, (cin, cout) in enumerate(stem_chans, start=1):
        params["stem"][f"conv{i}"] = conv(3, cin, cout)
        params["stem"][f"bn{i}"], stats["stem"][f"bn{i}"] = bn(cout)

    cin = w
    for stage, n_blocks in enumerate(cfg.blocks, start=1):
        planes = w * (2 ** (stage - 1))
        cout = planes * EXPANSION
        stage_p: List[Dict] = []
        stage_s: List[Dict] = []
        for b in range(n_blocks):
            stride = (2 if stage > 1 else 1) if b == 0 else 1
            bp = {"conv1": conv(1, cin, planes), "conv2": conv(3, planes, planes),
                  "conv3": conv(1, planes, cout)}
            bs: Dict = {}
            bp["bn1"], bs["bn1"] = bn(planes)
            bp["bn2"], bs["bn2"] = bn(planes)
            bp["bn3"], bs["bn3"] = bn(cout)
            if b == 0 and (stride > 1 or cin != cout):
                bp["down_conv"] = conv(1, cin, cout)
                bp["down_bn"], bs["down_bn"] = bn(cout)
            stage_p.append(bp)
            stage_s.append(bs)
            cin = cout
        params[f"layer{stage}"] = stage_p
        stats[f"layer{stage}"] = stage_s
    return params, stats


# ---------------------------------------------------------------------------
# Inference-mode BN folding (serving path)
# ---------------------------------------------------------------------------


def fold_bn(params: Dict, stats: Dict, cfg: ClipResNetConfig) -> Dict:
    """Fold inference BatchNorm into the convs (``clip_resnet.py:178-226``):
    BN(conv(x)) == conv(x, W * s) + b with s = scale / sqrt(var + eps) per
    output channel (dim 0 of OIHW) and b = bias - mean * s, both stored
    bf16, so the folded tower runs bf16 end to end.  Returns a new tree
    whose convs are {"kernel", "bias"} and whose bn entries are gone."""

    def fold(conv, bn_p, bn_s):
        inv = (bn_p["scale"] * torch.rsqrt(bn_s["var"] + cfg.bn_eps)).float()
        return {"kernel": (conv.float() * inv[:, None, None, None]).to(torch.bfloat16),
                "bias": (bn_p["bias"] - bn_s["mean"] * inv).to(torch.bfloat16)}

    folded: Dict = {"stem": {
        f"conv{i}": fold(params["stem"][f"conv{i}"], params["stem"][f"bn{i}"],
                         stats["stem"][f"bn{i}"])
        for i in (1, 2, 3)}}
    for stage in range(1, 5):
        blocks = []
        for bp, bs in zip(params[f"layer{stage}"], stats[f"layer{stage}"]):
            fb = {f"conv{j}": fold(bp[f"conv{j}"], bp[f"bn{j}"], bs[f"bn{j}"])
                  for j in (1, 2, 3)}
            if "down_conv" in bp:
                fb["down_conv"] = fold(bp["down_conv"], bp["down_bn"], bs["down_bn"])
            blocks.append(fb)
        folded[f"layer{stage}"] = blocks
    return folded


def is_folded(params: Dict) -> bool:
    return isinstance(params["stem"]["conv1"], dict)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    if k == 1:
        return x
    ph, pw = _same_pads(x.shape[2], k, stride), _same_pads(x.shape[3], k, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int, dtype) -> torch.Tensor:
    """NCHW conv, "SAME" for k > 1 and "VALID" for 1x1; fp32 result."""
    x = _pad_same(x, kernel.shape[-1], stride)
    return F.conv2d(x.to(dtype), kernel.to(dtype), stride=stride).float()


def _fconv(x: torch.Tensor, p: Dict, stride: int = 1) -> torch.Tensor:
    """Folded conv: conv + bias in the kernel's dtype (bf16), no fp32 round
    trip.  x must already be in that dtype, as ``lax.conv`` requires."""
    x = _pad_same(x, p["kernel"].shape[-1], stride)
    return F.conv2d(x, p["kernel"], stride=stride) + p["bias"][None, :, None, None]


def _bottleneck_folded(x, bp, stride):
    out = torch.relu(_fconv(x, bp["conv1"]))
    out = torch.relu(_fconv(out, bp["conv2"]))
    if stride > 1:
        out = _avgpool(out, stride)
    out = _fconv(out, bp["conv3"])
    if "down_conv" in bp:
        sc = _avgpool(x, stride) if stride > 1 else x
        sc = _fconv(sc, bp["down_conv"])
    else:
        sc = x
    return torch.relu(out + sc)


def _apply_folded(params: Dict, images: torch.Tensor, cfg: ClipResNetConfig) -> torch.Tensor:
    cdt = to_dtype(cfg.compute_dtype)
    x = images.to(cdt)
    for i, stride in enumerate((2, 1, 1), start=1):
        x = torch.relu(_fconv(x, params["stem"][f"conv{i}"], stride))
    x = _avgpool(x, 2)
    for stage in range(1, 5):
        for b, bp in enumerate(params[f"layer{stage}"]):
            x = _bottleneck_folded(x, bp, (2 if stage > 1 else 1) if b == 0 else 1)
    return x.flatten(2).transpose(1, 2).to(cdt)


def _bn(x: torch.Tensor, p: Dict, s: Dict, eps: float) -> torch.Tensor:
    """Inference BatchNorm over NCHW fp32 from the running statistics."""

    def c(t):
        return t.float()[None, :, None, None]

    return (x - c(s["mean"])) * torch.rsqrt(c(s["var"]) + eps) * c(p["scale"]) + c(p["bias"])


def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.avg_pool2d(x, k)  # VALID k x k window, stride k


def _bottleneck(x, bp, bs, stride, cfg):
    """1x1 -> 3x3 -> (avgpool if stride) -> 1x1, with an avgpool + 1x1
    shortcut on downsampling blocks."""
    cdt, eps = to_dtype(cfg.compute_dtype), cfg.bn_eps
    out = torch.relu(_bn(_conv(x, bp["conv1"], 1, cdt), bp["bn1"], bs["bn1"], eps))
    out = torch.relu(_bn(_conv(out, bp["conv2"], 1, cdt), bp["bn2"], bs["bn2"], eps))
    if stride > 1:
        out = _avgpool(out, stride)
    out = _bn(_conv(out, bp["conv3"], 1, cdt), bp["bn3"], bs["bn3"], eps)
    if "down_conv" in bp:
        sc = _avgpool(x, stride) if stride > 1 else x
        sc = _bn(_conv(sc, bp["down_conv"], 1, cdt), bp["down_bn"], bs["down_bn"], eps)
    else:
        sc = x
    return torch.relu(out + sc)


def apply(params: Dict, stats: Dict, images: torch.Tensor, cfg: ClipResNetConfig,
          *, train: bool = False) -> Tuple[torch.Tensor, Dict]:
    """(b, 3, H, W) images -> ((b, tokens, out_dim) features in the compute
    dtype, batch stats unchanged).  Inference mode only; ``fold_bn``'s
    folded params run the bf16 serving tower."""
    if train:
        raise NotImplementedError("the port's CLIP ResNet has no training mode yet")
    if is_folded(params):
        return _apply_folded(params, images, cfg), stats
    cdt = to_dtype(cfg.compute_dtype)
    x = images.float()
    for i, stride in enumerate((2, 1, 1), start=1):
        x = _conv(x, params["stem"][f"conv{i}"], stride, cdt)
        x = torch.relu(_bn(x, params["stem"][f"bn{i}"], stats["stem"][f"bn{i}"], cfg.bn_eps))
    x = _avgpool(x, 2)
    for stage in range(1, 5):
        for b, (bp, bs) in enumerate(zip(params[f"layer{stage}"], stats[f"layer{stage}"])):
            stride = (2 if stage > 1 else 1) if b == 0 else 1
            x = _bottleneck(x, bp, bs, stride, cfg)
    # "b d h w -> b (h w) d"
    return x.flatten(2).transpose(1, 2).to(cdt), stats
