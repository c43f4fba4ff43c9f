"""Sequence-sharded KV-cache decode attention (context-parallel serving).

Port of ``magma_tpu/parallel/sp_decode.py``.  The cache's position axis is
sharded over a mesh axis: rank i holds positions ``[i s_loc, (i + 1)
s_loc)``.  Each decode step scores the query against the local positions
only, then the shards combine through two tiny collectives: an all_reduce
MAX of the row maxima, and one all_reduce SUM of the denominator and one of
the weighted V.  The cache never moves.

Numerics follow ``ops/attention.decode_attention`` as the JAX function
does: fp32 scores with an int8 cache's scales folded per (position, head),
one global-max softmax over the valid cache positions and the current
token, probabilities cast to the weight dtype before the PV product, whose
shards are summed in fp32 before their one rounding.
Plain torch, as in the JAX package, which has no kernel here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from magma_tpu_torch.ops.attention import NEG_INF
from magma_tpu_torch.parallel.mesh import Mesh, all_reduce


def sp_decode_attention(
    q: torch.Tensor,                # (b, 1, h, hd), the same on every rank
    k_loc: torch.Tensor,            # (b, s_loc, h, hd): this rank's positions
    v_loc: torch.Tensor,
    cur_len,                        # int, scalar or (b,): valid cache entries
    self_kv: Tuple[torch.Tensor, torch.Tensor],  # current token's K/V (b, 1, h, hd)
    mesh: Mesh,
    axis: str,
    *,
    scale: float,
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # each (b, h, s_loc)
) -> torch.Tensor:
    """``decode_attention(q, k, v, cur_len, self_kv=...)`` over a cache whose
    position axis is sharded over ``axis``; returns the (b, 1, h, hd)
    output, the same on every rank of the axis."""
    b, s_loc = k_loc.shape[:2]
    dev = q.device
    off = mesh.axis_index(axis) * s_loc
    qf = q.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_loc.to(q.dtype).float()) * scale
    if kv_scales is not None:
        scores = scores * kv_scales[0][:, :, None, :].float()
    cur = torch.as_tensor(cur_len, device=dev).to(torch.int32).reshape(-1).expand(b)
    pos = off + torch.arange(s_loc, device=dev)[None, :]
    valid = (pos < cur[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)

    k_self, v_self = self_kv
    s_self = torch.einsum("bqhd,bkhd->bhqk", qf, k_self.to(q.dtype).float()) * scale

    # the global max over [cache | self]: one all_reduce of (b, h, 1, 1)
    m = all_reduce(scores.amax(dim=-1, keepdim=True), mesh, axis, op="max")
    m = torch.maximum(m, s_self)
    e_loc = torch.exp(scores - m)
    e_self = torch.exp(s_self - m)
    den = all_reduce(e_loc.sum(dim=-1, keepdim=True), mesh, axis) + e_self
    # probabilities in the weight dtype before PV, as the reference
    wdt = q.dtype if kv_scales is not None else v_loc.dtype
    w_loc = (e_loc / den).to(wdt)
    if kv_scales is not None:
        w_loc = w_loc * kv_scales[1][:, :, None, :].to(wdt)
    # the shards' PV sums add in fp32 and round once to wdt, as the one
    # product over the whole cache of decode_attention does (JAX sums the
    # rounded shards)
    out = torch.einsum("bhqk,bkhd->bqhd", w_loc.float(), v_loc.to(wdt).float()).contiguous()
    out = all_reduce(out, mesh, axis).to(wdt)
    return out + torch.einsum("bhqk,bkhd->bqhd", (e_self / den).to(wdt).float(),
                              v_self.to(wdt).float()).to(wdt)
