"""Plain float32 reference of MAGMA's serving forward, in PyTorch.

Written from the published description (MAGMA, arXiv:2112.05253: a CLIP
ResNet whose attention pool is replaced by flattening its 12 x 12 map into
144 tokens, a linear projection and a layernorm in front of a frozen GPT-J
with bottleneck adapters), not from the program under test, and importing
nothing of it.  Everything runs in float32 with TF32 off; nothing is cached
or batched across requests, and every weight the program's set-up derives
from the seeded weights is derived here again:

* weight-only quantization of the LM (``quantize``): int8 with one scale per
  output column, max|w| / 127; the control's int4 with one scale per group
  of 256 rows (two groups at widths that are no multiple of 512) and
  column, max|w| / 7.  The head is the embedding's transpose, quantized
  likewise.  Adapters whose widths are multiples of 128 are int8 in the
  serving layout, others bf16.
* the tower's inference BatchNorm, applied as written (the program folds it
  into its convs; the two are the same function).

Departures from the published models, each the program's own convention
that the reference follows so that a difference means a fault: 3 x 3 convs
pad as XLA's "SAME" (at stride 2 on an even side (0, 1), where torch CLIP
pads (1, 1)); GELU is the tanh form (GPT-J's ``gelu_new``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
INT4_GROUP = 256
ADAPTER_ALIGN = 128


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize(w: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """(K, N) weights -> the float32 values a weight-only ``bits`` layout
    holds (None: the weights as they are)."""
    w = w.float()
    if bits is None:
        return w
    if bits == 8:
        scale = w.abs().amax(dim=0, keepdim=True).clamp(min=1e-8) / 127.0
        return torch.clamp(torch.round(w / scale), -127, 127) * scale
    if bits == 4:
        K, N = w.shape
        group = INT4_GROUP if K % (2 * INT4_GROUP) == 0 else K // 2
        wg = w.reshape(K // group, group, N)
        scale = wg.abs().amax(dim=1, keepdim=True).clamp(min=1e-8) / 7.0
        return (torch.clamp(torch.round(wg / scale), -7, 7) * scale).reshape(K, N)
    raise ValueError(f"bits must be None, 8 or 4, got {bits}")


# ---------------------------------------------------------------------------
# Vision: preprocessing, CLIP ResNet, ImagePrefix
# ---------------------------------------------------------------------------


def preprocess(image: np.ndarray, n_px: int, device) -> torch.Tensor:
    """uint8 (h, w, 3) -> (1, 3, n_px, n_px): bicubic resize of the short
    side to n_px (antialiased), centre crop, CLIP's normalisation."""
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device).float().div(255.0)
    h, w = x.shape[:2]
    if h <= w:
        size = (n_px, max(n_px, int(round(w * n_px / h))))
    else:
        size = (max(n_px, int(round(h * n_px / w))), n_px)
    x = F.interpolate(x.permute(2, 0, 1)[None], size=size, mode="bicubic", align_corners=False,
                      antialias=True)
    top, left = (size[0] - n_px) // 2, (size[1] - n_px) // 2
    x = x[:, :, top:top + n_px, left:left + n_px]
    mean = torch.tensor(CLIP_MEAN, device=device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=device)[None, :, None, None]
    return (x - mean) / std


def _conv(x, w, stride):
    k = w.shape[-1]
    if k > 1:  # XLA "SAME"
        pads = []
        for n in (x.shape[3], x.shape[2]):
            out = -(-n // stride)
            total = max((out - 1) * stride + k - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads)
    return F.conv2d(x, w.float(), stride=stride)


def _bn(x, p, s, eps):
    inv = p["scale"].float() / torch.sqrt(s["var"].float() + eps)
    return x * inv[None, :, None, None] + (p["bias"].float() - s["mean"].float() * inv)[
        None, :, None, None]


def tower(enc: Dict, stats: Dict, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """CLIP's ModifiedResNet without its attention pool: (b, 3, H, W) ->
    (b, (H/32)^2, width * 32)."""
    eps = cfg["bn_eps"]
    for i, stride in enumerate((2, 1, 1), start=1):
        x = torch.relu(_bn(_conv(x, enc["stem"][f"conv{i}"], stride), enc["stem"][f"bn{i}"],
                           stats["stem"][f"bn{i}"], eps))
    x = F.avg_pool2d(x, 2)
    for stage in range(1, len(cfg["blocks"]) + 1):
        for b, (bp, bs) in enumerate(zip(enc[f"layer{stage}"], stats[f"layer{stage}"])):
            stride = (2 if stage > 1 else 1) if b == 0 else 1
            out = torch.relu(_bn(_conv(x, bp["conv1"], 1), bp["bn1"], bs["bn1"], eps))
            out = torch.relu(_bn(_conv(out, bp["conv2"], 1), bp["bn2"], bs["bn2"], eps))
            if stride > 1:
                out = F.avg_pool2d(out, stride)
            out = _bn(_conv(out, bp["conv3"], 1), bp["bn3"], bs["bn3"], eps)
            sc = x
            if "down_conv" in bp:
                sc = F.avg_pool2d(x, stride) if stride > 1 else x
                sc = _bn(_conv(sc, bp["down_conv"], 1), bp["down_bn"], bs["down_bn"], eps)
            x = torch.relu(out + sc)
    return x.flatten(2).transpose(1, 2)


def _layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale.float() + bias.float()


def image_prefix(weights: Dict, image: np.ndarray, model: Dict, device) -> torch.Tensor:
    """One uint8 image -> its (tokens, d_model) prefix embeddings."""
    p = weights["image_prefix"]
    x = preprocess(image, model["tower"]["input_resolution"], device)
    feats = tower(p["enc"], weights["stats"]["enc"], x, model["tower"])[0]
    e = feats @ p["proj"]["kernel"].float() + p["proj"]["bias"].float()
    if "ln" in p:
        e = _layer_norm(e, p["ln"]["scale"], p["ln"]["bias"], 1e-5)
    return e


def embed_prompt(weights: Dict, parts: Sequence, model: Dict, device) -> torch.Tensor:
    """A prompt's parts in order (uint8 (h, w, 3) images, 1-D token id
    arrays) -> its (s, d_model) embeddings."""
    wte = weights["lm"]["wte"]
    out = []
    for part in parts:
        if isinstance(part, np.ndarray) and part.ndim == 3:
            out.append(image_prefix(weights, part, model, device))
        else:
            out.append(wte[torch.as_tensor(np.asarray(part), device=device).long()].float())
    return torch.cat(out)


# ---------------------------------------------------------------------------
# GPT-J with adapters
# ---------------------------------------------------------------------------


def _rotary(x: torch.Tensor, positions: torch.Tensor, rot: int) -> torch.Tensor:
    """GPT-J's rotate-every-two over the first ``rot`` dims of (s, h, hd)."""
    half = rot // 2
    inv_freq = 1.0 / 10000.0 ** (torch.arange(half, device=x.device).float() / half)
    ang = positions.float()[:, None] * inv_freq
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)
    return torch.cat([rotated, x[..., rot:]], dim=-1)


def _adapter_weights(ad: Dict, layer: int, d: int, bits: Optional[int]) -> Dict:
    """One layer's bottleneck as the serving layout holds it."""
    dh = ad["down"]["kernel"].shape[-1]
    fused = bits is not None and d % ADAPTER_ALIGN == 0 and dh % ADAPTER_ALIGN == 0 \
        and "ln" not in ad
    if fused:
        wd, wu = (quantize(ad[k]["kernel"][layer], 8) for k in ("down", "up"))
    else:
        wd, wu = (ad[k]["kernel"][layer].to(torch.bfloat16).float() if bits is not None
                  else ad[k]["kernel"][layer].float() for k in ("down", "up"))
    out = {"wd": wd, "bd": ad["down"]["bias"][layer].float(), "wu": wu,
           "bu": ad["up"]["bias"][layer].float()}
    if "ln" in ad:
        out["ln"] = (ad["ln"]["scale"][layer], ad["ln"]["bias"][layer])
    if "scale" in ad:
        out["scale"] = ad["scale"][layer].float()
    return out


def _adapter(aw: Dict, kind: str, branch_in, branch_out):
    x = branch_out if kind == "normal" else branch_in
    if "ln" in aw:
        x = _layer_norm(x, *aw["ln"], 1e-5)
    z = torch.relu(x @ aw["wd"] + aw["bd"]) @ aw["wu"] + aw["bu"]
    if kind == "scaled_parallel":
        z = z * aw["scale"]
    return branch_out + z


def lm_logits(weights: Dict, model: Dict, embeds: List[torch.Tensor],
              served: List[Sequence[int]], bits: Optional[int] = 8,
              head_bits: Optional[int] = 8) -> List[torch.Tensor]:
    """Teacher-forced logits of each served token: for prompt embeddings
    (s, D) and served tokens t_1..t_n, the logits (n, vocab) at positions
    s - 1 .. s + n - 2, i.e. the distributions t_1..t_n were drawn from.
    ``bits`` is the layout of the layers' weights, ``head_bits`` the head's.
    Layer by layer over all sequences at once, so one layer's float32
    weights are resident at a time."""
    lm, cfg = weights["lm"], model["lm"]
    D, H, rot, eps = cfg["d_model"], cfg["n_heads"], cfg["rotary_dim"], cfg["ln_eps"]
    hd = D // H
    wte = lm["wte"]
    seqs = []
    for e, toks in zip(embeds, served):
        prev = torch.as_tensor(list(toks[:-1]), device=e.device, dtype=torch.long)
        seqs.append(torch.cat([e.float(), wte[prev].float()]) if len(prev) else e.float())
    lens = [s.shape[0] for s in seqs]
    x = torch.cat(seqs)
    pos = torch.cat([torch.arange(n, device=x.device) for n in lens])
    blocks = lm["blocks"]
    adapters = model.get("adapters", {})
    for layer in range(cfg["n_layers"]):
        u = _layer_norm(x, blocks["ln_1"]["scale"][layer], blocks["ln_1"]["bias"][layer], eps)
        q, k, v = (u @ quantize(blocks["attn"][n][layer], bits) for n in ("q", "k", "v"))
        q, k, v = (t.view(-1, H, hd) for t in (q, k, v))
        q, k = _rotary(q, pos, rot), _rotary(k, pos, rot)
        ctx, off = [], 0
        for n in lens:
            qs, ks, vs = (t[off:off + n].transpose(0, 1) for t in (q, k, v))
            scores = qs @ ks.transpose(1, 2) / hd ** 0.5
            mask = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
            probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
            ctx.append((probs @ vs).transpose(0, 1).reshape(n, D))
            off += n
        a = torch.cat(ctx) @ quantize(blocks["attn"]["o"][layer], bits)
        if "o_bias" in blocks["attn"]:
            a = a + blocks["attn"]["o_bias"][layer].float()
        if "attention" in adapters:
            aw = _adapter_weights(blocks["adapter_attn"], layer, D, bits)
            a = _adapter(aw, adapters["attention"]["adapter_type"], u, a)
        h = u @ quantize(blocks["mlp"]["fc_in"]["kernel"][layer], bits)
        h = F.gelu(h + blocks["mlp"]["fc_in"]["bias"][layer].float(), approximate="tanh")
        m = h @ quantize(blocks["mlp"]["fc_out"]["kernel"][layer], bits)
        m = m + blocks["mlp"]["fc_out"]["bias"][layer].float()
        if "mlp" in adapters:
            aw = _adapter_weights(blocks["adapter_mlp"], layer, D, bits)
            m = _adapter(aw, adapters["mlp"]["adapter_type"], u, m)
        x = x + a + m
    x = _layer_norm(x, lm["ln_f"]["scale"], lm["ln_f"]["bias"], eps)
    head = quantize(wte.float().T, head_bits)[:, :cfg["vocab_size"]]
    out, off = [], 0
    for n, toks in zip(lens, served):
        s = n - (len(toks) - 1)
        out.append(x[off + s - 1:off + n] @ head)
        off += n
    return out


def gaps(logits: List[torch.Tensor], tokens: List[Sequence[int]]) -> torch.Tensor:
    """For every served token, how far its logit lies below the best one."""
    out = []
    for lg, toks in zip(logits, tokens):
        t = torch.as_tensor(list(toks), device=lg.device, dtype=torch.long)
        out.append(lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out)
