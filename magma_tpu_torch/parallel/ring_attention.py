"""Ring attention: causal attention with the sequence sharded over a mesh
axis, K/V blocks rotating around the ring.

Port of ``magma_tpu/parallel/ring_attention.py``.  Rank i of the axis holds
the contiguous positions ``[i s_loc, (i + 1) s_loc)`` of q, k and v; at
step t it attends its queries to the block of rank ``(i - t) % n`` and
passes that block on to ``(i + 1) % n`` (``dist.batch_isend_irecv``,
started before the step's attention so the transfer overlaps it).  A
block wholly in this rank's future is skipped, not masked
(``ring_attention.py:94-113``); the diagonal block runs causal, the past
ones unmasked.

Each step is K1 (``ops/flash_attention.flash_attention_fwd``: O and lse),
and the steps' outputs merge through their lse in fp32.  The backward is a
``torch.autograd.Function``: with the merged O and lse and D = rowsum(dO
O), each live step's gradients are K9b (dQ) and K9a (dK, dV) against the
block, and a second ring carries each block's dK/dV accumulators with it,
home after n hops.  JAX computes each step with einsums and takes the
gradient by autodiff through its scan and ppermute; the function is the
same.  On CPU tensors the steps are the kernels' plain versions.

Every row sees at least its own position (the diagonal block, step 0), so
no row is left with no visible key: the merge starts from step 0's
finite lse.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from magma_tpu_torch.parallel.mesh import Mesh


def _step_fwd(q, k, v, *, scale, causal):
    """(O, lse (b, h, s_q) fp32) of one block pair: K1 on CUDA tensors."""
    from magma_tpu_torch.ops import flash_attention as fa

    if q.is_cuda:
        return fa.flash_attention_fwd(q, k, v, scale=scale, causal=causal)
    return fa._plain_core(q, k, v, None, scale=scale, causal=causal, q_offset=0)


def _step_bwd(q, k, v, o, lse, do, di, *, scale, causal):
    """(dq, dk, dv) of one block pair under the merged (O, lse): K9b and
    K9a on CUDA tensors, the plain backward (which takes D from O dO, the
    same di) on CPU ones."""
    from magma_tpu_torch.ops import flash_attention as fa

    if q.is_cuda:
        kw = dict(scale=scale, causal=causal, q_offset=0)
        dk, dv = fa.flash_attention_bwd_dkv_kernel(q, k, v, do, lse, di, None, **kw)
        dq = fa.flash_attention_bwd_dq_kernel(q, k, v, do, lse, di, None, **kw)
        return dq, dk, dv
    return fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale, causal=causal)


def _exchange(mesh: Mesh, axis: str, send, recv):
    """Start sending ``send`` to the next rank of the ring and receiving
    ``recv`` from the previous one; returns the requests."""
    line = mesh.line(axis)
    i = line.index(mesh.rank)
    nxt, prv = line[(i + 1) % len(line)], line[(i - 1) % len(line)]
    g = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, t, nxt, group=g) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv, group=g) for t in recv]
    return dist.batch_isend_irecv(ops)


def _wait(reqs):
    for r in reqs:
        r.wait()


def _live(src: int, idx: int, causal: bool) -> bool:
    return not causal or src <= idx


def _merge(o_acc, lse_acc, o_t, lse_t):
    """Two partial attentions over disjoint keys -> their union's (O fp32,
    lse): each O weighted by exp(its lse - the union's)."""
    lse = torch.logaddexp(lse_acc, lse_t)
    a = torch.exp(lse_acc - lse).transpose(1, 2)[..., None]
    b = torch.exp(lse_t - lse).transpose(1, 2)[..., None]
    return o_acc * a + o_t.float() * b, lse


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, scale, causal):
        n, idx = mesh.size(axis), mesh.axis_index(axis)
        k_blk, v_blk = k.contiguous(), v.contiguous()
        o_acc = lse_acc = None
        for t in range(n):
            reqs = []
            if t < n - 1:
                k_nxt, v_nxt = torch.empty_like(k_blk), torch.empty_like(v_blk)
                reqs = _exchange(mesh, axis, (k_blk, v_blk), (k_nxt, v_nxt))
            src = (idx - t) % n
            if _live(src, idx, causal):
                o_t, lse_t = _step_fwd(q, k_blk, v_blk, scale=scale,
                                       causal=causal and src == idx)
                if o_acc is None:
                    o_acc, lse_acc = o_t.float(), lse_t
                else:
                    o_acc, lse_acc = _merge(o_acc, lse_acc, o_t, lse_t)
            _wait(reqs)
            if t < n - 1:
                k_blk, v_blk = k_nxt, v_nxt
        o = o_acc.to(q.dtype)
        lse = lse_acc.contiguous()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.axis, ctx.scale, ctx.causal = mesh, axis, scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, scale, causal = ctx.mesh, ctx.axis, ctx.scale, ctx.causal
        n, idx = mesh.size(axis), mesh.axis_index(axis)
        do = do.contiguous()
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k.contiguous(), v.contiguous()
        dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros_like(dk_acc)
        for t in range(n):
            send, recv = [], []
            if t < n - 1:
                k_nxt, v_nxt = torch.empty_like(k_blk), torch.empty_like(v_blk)
                send, recv = [k_blk, v_blk], [k_nxt, v_nxt]
            src = (idx - t) % n
            if _live(src, idx, causal):
                dq_t, dk_t, dv_t = _step_bwd(q, k_blk, v_blk, o, lse, do, di, scale=scale,
                                             causal=causal and src == idx)
                dq += dq_t.float()
                dk_acc += dk_t.float()
                dv_acc += dv_t.float()
            reqs = []
            if n > 1:
                # the block's gradient travels with it; after the last step
                # it takes its n-th hop, home
                dk_in, dv_in = torch.empty_like(dk_acc), torch.empty_like(dv_acc)
                reqs = _exchange(mesh, axis, send + [dk_acc, dv_acc], recv + [dk_in, dv_in])
            _wait(reqs)
            if n > 1:
                dk_acc, dv_acc = dk_in, dv_in
            if t < n - 1:
                k_blk, v_blk = k_nxt, v_nxt
        return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype), None, None, None, None


def ring_attention(
    q: torch.Tensor,  # (b, s_loc, h, hd): this rank's query shard
    k: torch.Tensor,  # (b, s_loc, h, hd): this rank's key shard
    v: torch.Tensor,
    mesh: Mesh,
    axis: str,
    *,
    scale: float,
    causal: bool = True,
) -> torch.Tensor:
    """Attention of this rank's queries over the whole ring's keys, the
    sequence sharded contiguously over ``axis``.  Differentiable in q, k
    and v.  On CUDA tensors the shard length must be a multiple of 128 (the
    flash kernels' block; the JAX wrapper pads, a ring cannot)."""
    if q.is_cuda and q.shape[1] % 128:
        raise ValueError(f"ring attention on the card needs a shard length that is a "
                         f"multiple of 128, got {q.shape[1]}")
    return _Ring.apply(q, k, v, mesh, axis, float(scale), bool(causal))


def context_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    scale: float,
    causal: bool = True,
    seq_axis: str = "dp",
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """``ring_attention`` over ``seq_axis``, the JAX package's entry.  The
    port holds no global arrays: q, k and v are already this rank's batch
    shard (over ``batch_axis``, as JAX's shard_map keeps it) and sequence
    shard, so ``batch_axis`` selects nothing here."""
    if batch_axis is not None and batch_axis not in mesh.axis_names:
        raise ValueError(f"batch_axis {batch_axis!r} is not a mesh axis {mesh.axis_names}")
    return ring_attention(q, k, v, mesh, seq_axis, scale=scale, causal=causal)
