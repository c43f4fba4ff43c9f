"""Multi-head attention ops: causal (prefill) and KV-cache decode.

Port of ``magma_tpu/ops/attention.py``.  Two prefill implementations:

* ``impl="xla"``   -- plain einsum + masked softmax (the JAX package's
  XLA path), materialising the (s, s) scores.
* ``impl="flash"`` -- ``ops/flash_attention.flash_attention``: the
  hand-written CUDA kernel on a GPU tensor, its plain torch version on a
  CPU tensor.  An input the kernel does not take raises; unlike the JAX
  package (``attention.py:94-95``) nothing falls back to the einsum path.

All ops take and return (b, s, h, hd); softmax statistics are fp32 whatever
the input dtype.  The int8 cache and ``history_attention`` are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

# the JAX package's masking constant (attention.py:24): a float64 product,
# rounded to float32 where it meets a float32 tensor
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _causal_mask(s_q: int, s_k: int, q_offset: int, device) -> torch.Tensor:
    """Boolean (s_q, s_k), True where q row i (global q_offset + i) may see
    key j, i.e. j <= q_offset + i."""
    rows = torch.arange(s_q, device=device)[:, None] + q_offset
    cols = torch.arange(s_k, device=device)[None, :]
    return cols <= rows


def _scores_f32(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(b, q, h, d) x (b, k, h, d) -> fp32 (b, h, q, k) scores * scale, as
    ``einsum(..., preferred_element_type=float32)`` gives them."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference attention.  q: (b, s_q, h, hd); k, v: (b, s_k, h, hd);
    kv_len: optional (b,) true key lengths of right-padded rows."""
    b, s_q = q.shape[:2]
    s_k = k.shape[1]
    scores = _scores_f32(q, k, scale)
    mask = None
    if causal:
        mask = _causal_mask(s_q, s_k, q_offset, q.device)[None, None]
    if kv_len is not None:
        klm = (torch.arange(s_k, device=q.device)[None, :]
               < kv_len.to(q.device)[:, None])[:, None, None, :]
        mask = klm if mask is None else mask & klm
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    impl: str = "flash",
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal multi-head attention with an optional right-padding mask."""
    if impl == "flash":
        from magma_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, scale=scale, causal=True,
                               kv_len=kv_len, q_offset=q_offset)
    if impl != "xla":
        raise ValueError(f"attention impl must be 'flash' or 'xla', got {impl!r}")
    return xla_attention(q, k, v, scale=scale, causal=True,
                         q_offset=q_offset, kv_len=kv_len)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len,
    *,
    scale: float,
    self_kv=None,
) -> torch.Tensor:
    """Single-token attention against a fixed-shape bf16 KV cache.

    q: (b, 1, h, hd); k_cache/v_cache: (b, max_len, h, hd); cur_len: (b,)
    or scalar count of valid cache entries.  ``self_kv=(k_new, v_new)``
    adds the current token's K/V as an extra key, so the cache write can
    wait for one bulk update after all layers (gptj._write_cache)."""
    b = q.shape[0]
    max_len = k_cache.shape[1]
    scores = _scores_f32(q, k_cache, scale)
    cur_len = torch.as_tensor(cur_len, device=q.device).reshape(-1).expand(b)
    valid = (torch.arange(max_len, device=q.device)[None, :]
             < cur_len[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)
    if self_kv is not None:
        k_self, v_self = self_kv
        scores = torch.cat([scores, _scores_f32(q, k_self, scale)], -1)
    # weights round to the cache dtype, as in the JAX package; each product
    # then accumulates in fp32 and rounds once to that dtype
    wdt = v_cache.dtype
    weights = torch.softmax(scores, dim=-1).to(wdt).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights[..., :max_len],
                       v_cache.float()).to(wdt)
    if self_kv is not None:
        out = out + torch.einsum("bhqk,bkhd->bqhd", weights[..., max_len:],
                                 v_self.to(wdt).float()).to(wdt)
    return out
