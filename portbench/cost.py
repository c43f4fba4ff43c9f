"""The yardstick's arithmetic: the card's peaks, each kernel family's
operations and bytes from its shapes, and the model FLOPs a piece of work
requires.

Peaks are NVIDIA's data sheet for the H100 SXM (dense): bf16 989 TFLOP/s
(the int8 products here run bf16 on the tensor cores), HBM3 3.35 TB/s, at
its full 700 W.  A roofline share
counts each input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_s(n_bytes: float, ops: float, peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: every byte once at the HBM rate
    or every operation at ``peak``, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / peak)


# --- kernel families (the int8 products run bf16 x dequantised int8 on the
# bf16 tensor cores, so their peak is bf16's) --------------------------------

def int8_matmul(m: int, k: int, n: int):
    """K2a / K2b: x (m, k) bf16 @ w (k, n) int8 * s (n,) fp32 -> fp32."""
    return 2 * m * k + k * n + 4 * n + 4 * m * n, 2 * m * k * n


def int8_dual(m: int, ko: int, kf: int, n: int):
    """K4a: two int8 products of m rows into n columns in one launch."""
    b1, f1 = int8_matmul(m, ko, n)
    b2, f2 = int8_matmul(m, kf, n)
    return b1 + b2, f1 + f2


def fused_adapter(m: int, d: int, dh: int):
    """K5: relu(x Wd sd + bd) Wu su + bu for x (m, d) bf16, int8 Wd, Wu."""
    n_bytes = 2 * m * d + 2 * d * dh + 4 * (2 * dh + 2 * d) + 4 * m * d
    return n_bytes, 4 * m * d * dh


def decode_all_layers(lm: Dict, adapter_widths: Iterable[int], cache_read: int,
                      kv_bytes: int = 2):
    """K8: one decode step of every layer at b = 1 but layer 0's in_proj
    (K2b's): the out projections, the next layers' in_proj, the int8
    adapters and their vectors, the cache's ``cache_read`` positions of K
    and V read and the new entries written, the fp32 bias and norm vectors."""
    L, D, F = lm["n_layers"], lm["d_model"], lm["d_ff"]
    w_out = D * D + F * D + 2 * 4 * D
    w_in = D * (3 * D + F) + 4 * (3 * D + F)
    w_ad = sum(2 * D * dh + 4 * (2 * dh + 2 * D) for dh in adapter_widths)
    vecs = 4 * (F + 4 * D)
    cache = 2 * (cache_read + 1) * D * kv_bytes
    n_bytes = L * (w_out + w_ad + vecs + cache) + (L - 1) * w_in
    ops = 2 * (L * (D * D + F * D + sum(2 * D * dh for dh in adapter_widths))
               + (L - 1) * D * (3 * D + F)) + L * 4 * (cache_read + 1) * D
    return n_bytes, ops


# --- model FLOPs ------------------------------------------------------------

def lm_token_flops(lm: Dict, adapter_widths: Iterable[int], context: int,
                   head: bool = True) -> int:
    """One position through the LM: every product of its weights, attention
    over ``context`` positions (itself included), and the head if asked."""
    L, D, F, V = lm["n_layers"], lm["d_model"], lm["d_ff"], lm["vocab_size"]
    per_layer = 2 * (D * (3 * D + F) + D * D + F * D + sum(2 * D * dh for dh in adapter_widths))
    return L * (per_layer + 4 * context * D) + (2 * D * V if head else 0)


def prompt_flops(lm: Dict, adapter_widths: Iterable[int], n: int) -> int:
    """A causal prefill of n positions, the head at the last only."""
    widths = list(adapter_widths)
    body = sum(lm_token_flops(lm, widths, i + 1, head=False) for i in range(n))
    return body + 2 * lm["d_model"] * lm["vocab_size"]


def tower_flops(tower: Dict, d_model: int) -> int:
    """The CLIP ResNet at its input resolution and the prefix projection."""
    from portbench.weights import EXPANSION, tower_layout

    w, side = tower["width"], tower["input_resolution"] // 2
    flops = 2 * side * side * 9 * (3 * (w // 2) + (w // 2) * (w // 2) + (w // 2) * w)
    side //= 2
    for _, b, cin, planes, stride in tower_layout(tower):
        cout = planes * EXPANSION
        flops += 2 * side * side * (cin * planes + 9 * planes * planes)
        side_out = side // stride
        flops += 2 * side_out * side_out * planes * cout
        if cin != cout or stride > 1:
            flops += 2 * side_out * side_out * cin * cout
        side = side_out
    return flops + 2 * side * side * (w * 32) * d_model


def flash_fwd(b: int, s_q: int, s_k: int, h: int, hd: int, causal: bool,
              hd_v: Optional[int] = None):
    """K1: O = softmax(Q K^T) V for (b, s, h, hd) bf16 q, k and (b, s, h,
    hd_v) v (``hd_v`` defaults to ``hd``), with its fp32 log-sum-exp; causal
    work is the lower triangle.  Q K^T counts ``hd``; P V, and the bytes of
    v and o, count ``hd_v``."""
    hd_v = hd if hd_v is None else hd_v
    frac = (s_k + 1) / (2 * s_k) if causal and s_q == s_k else 1.0
    n_bytes = 2 * b * h * (s_q + s_k) * (hd + hd_v) + 4 * b * h * s_q
    return n_bytes, 2 * b * h * s_q * s_k * (hd + hd_v) * frac


def flash_bwd(b: int, s_q: int, s_k: int, h: int, hd: int, causal: bool,
              hd_v: Optional[int] = None, *, products: int, outputs: int):
    """K9a (``products`` 4: S, dP, dV, dK; ``outputs`` 2: dK, dV) or K9b (3:
    S, dP, dQ; 1: dQ): q, k, v, dO in bf16 and lse, delta in fp32 read.
    S = Q K^T and dK or dQ count ``hd``; dP = dO V^T and dV, and the bytes
    of v, dO and dV, count ``hd_v`` (default ``hd``)."""
    hd_v = hd if hd_v is None else hd_v
    frac = (s_k + 1) / (2 * s_k) if causal and s_q == s_k else 1.0
    written = s_k * (hd + hd_v) if outputs == 2 else s_q * hd
    n_bytes = 2 * b * h * (s_q + s_k) * (hd + hd_v) + 8 * b * h * s_q + 2 * b * h * written
    return n_bytes, 2 * b * h * s_q * s_k * (2 * hd + (products - 2) * hd_v) * frac


def train_sample_flops(model: Dict, n: int, labels: int) -> int:
    """The model FLOPs one training sample requires over its ``n`` true
    positions with ``labels`` predicted tokens: the LM forward, its backward
    to the inputs (the LM is frozen: no weight gradients but the adapters'),
    the head forward and backward at the labels, and each image through the
    tower and projection forward and backward (trainable: 3x forward)."""
    lm = model["lm"]
    L, D, F, V = lm["n_layers"], lm["d_model"], lm["d_ff"], lm["vocab_size"]
    widths = [D // a["downsample_factor"] for a in model.get("adapters", {}).values()]
    dense = 2 * (D * (3 * D + F) + D * D + F * D)
    adapters = 2 * sum(2 * D * dh for dh in widths)
    attn = sum(4 * (i + 1) * D for i in range(n))
    fwd = L * (n * (dense + adapters) + attn)
    bwd = L * (n * (dense + 2 * adapters) + 2 * attn)
    head = 3 * 2 * D * V * labels
    return fwd + bwd + head + 3 * tower_flops(model["tower"], D)
