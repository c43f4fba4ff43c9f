"""Flash attention: the CUDA kernels (forward K1, backward K9a and K9b),
their wrappers and their plain versions.

Port of ``magma_tpu/ops/flash_attention.py``: the Pallas ``_fwd_kernel``
(two CUDA bodies of the same function: ``csrc/flash_attn_fwd.cu`` for small
launches, ``csrc/flash_attn_fwd_wgmma.cu`` for large ones, chosen by
``flash_fwd_takes_wgmma`` from the shapes alone) and the backward of its
custom VJP, ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``
(``csrc/flash_attn_bwd.cu``).  The sources' headers say what bounds each
kernel and how it is built.

* ``flash_attention`` -- the differentiable public entry over (b, s, h, hd)
  tensors: a ``torch.autograd.Function`` whose forward is K1 and whose
  backward is K9a + K9b on CUDA tensors (launching them or raising), and
  the plain versions on CPU tensors.  Which one runs depends only on the
  device of the tensors given.
* ``flash_attention_fwd`` -- the forward alone, returning (O, lse).
* ``flash_attention_plain`` / ``flash_attention_bwd_plain`` -- the same
  functions in fp32 torch, on any device.  The CPU tests hold them against
  the JAX kernels, and ``chip_smoke.py`` holds the kernels against them.

Both keep the JAX wrapper's padding (``flash_attention.py:458-489``):
sequences pad up to a multiple of 128 (through autograd, so the padded
rows' gradients are cut off), padded keys are masked through ``kv_len``
(set to the true key length when the caller gave none) and padded query
rows are cut from the output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from magma_tpu_torch import observability as obs
from magma_tpu_torch.ops.attention import NEG_INF

SEQ_ALIGN = 128                  # the JAX wrapper's padding unit
KERNEL_HEAD_DIMS = (128, 256)    # head dims the CUDA kernels are built for
WGMMA_ROWS = 128                 # query rows a block of K1's wgmma body
WGMMA_MIN_BLOCKS = 132           # an H100's SMs: see flash_fwd_takes_wgmma


def flash_fwd_takes_wgmma(b: int, h: int, s_q: int, s_k: int, hd: int) -> bool:
    """Which body of K1 a launch of these shapes runs: True for the wgmma
    body (``csrc/flash_attn_fwd_wgmma.cu``), False for the mma.sync one
    (``csrc/flash_attn_fwd.cu``).  Both compute the whole function (every
    mask, head_dim 128 and 256), so the rule moves time, never the result
    beyond the stated tolerance; it reads shapes only.

    The wgmma body runs where its grid of 128-row blocks fills the card's
    132 SMs: a training layer's attention (b 2 or 1, s 2048, h 16: 512 or
    256 blocks).  ``scripts/torch_flash_crossover.py`` found no crossover
    (NVIDIA H100 80GB HBM3, 700 W; causal, b h 16 and 32, s 256-2048, hd
    256 and 128): the wgmma body is faster at every shape, 1.7-2.2x at
    32-64 blocks and 2.8-4.3x at 256-512.  So the threshold is not a speed
    crossover.  It keeps a b = 1 caption prefill of up to 1024 tokens (16
    heads: at most 128 blocks) on the mma.sync body, because the serving
    checks of ``chip_smoke.py`` do not all pass on the wgmma body's
    prefill: on the same card the int4 model's decode over an int8 cache
    (K8 against the b <= 8 path, held to 0.03) then reads 0.0311 in its v
    entries, 0.0277 after the mma.sync body's prefill.  A batch reaches the
    threshold sooner (b 5 or more at 256 tokens, 3 or more at 384) and
    then takes the wgmma body, whose bits differ from the same request's
    at b = 1."""
    blocks = b * h * -(-s_q // WGMMA_ROWS)
    return s_k > 0 and hd in KERNEL_HEAD_DIMS and blocks >= WGMMA_MIN_BLOCKS


def _pad_inputs(q, k, v, kv_len):
    """The JAX wrapper's padding.  Returns (q, k, v, kv_len or None)."""
    b, s_q, _, hd = q.shape
    s_k = k.shape[1]
    if hd % 128:
        raise NotImplementedError(f"head_dim must be a multiple of 128, got {hd}")
    pad_q, pad_k = (-s_q) % SEQ_ALIGN, (-s_k) % SEQ_ALIGN
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        if kv_len is None:
            kv_len = torch.full((b,), s_k, dtype=torch.int32, device=q.device)
    return q, k, v, kv_len


def _check_shapes(q, k, v, kv_len):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q, k, v must be (b, s, h, hd) with k.shape == v.shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in b, h or hd")
    if kv_len is not None and tuple(kv_len.shape) != (q.shape[0],):
        raise ValueError(f"kv_len must be ({q.shape[0]},), got {tuple(kv_len.shape)}")


def _mask(s_q, s_k, kv_len, *, causal, q_offset, device) -> torch.Tensor:
    """Boolean (b or 1, 1, s_q, s_k): True where query i (global position
    q_offset + i) may attend key j."""
    mask = torch.ones((1, 1, s_q, s_k), dtype=torch.bool, device=device)
    cols = torch.arange(s_k, device=device)
    if causal:
        rows = torch.arange(s_q, device=device)[:, None] + q_offset
        mask = mask & (cols[None, :] <= rows)[None, None]
    if kv_len is not None:
        mask = mask & (cols[None, :] < kv_len.to(device)[:, None])[:, None, None, :]
    return mask


def _plain_core(q, k, v, kv_len, *, scale, causal, q_offset):
    """Masked softmax attention in fp32 over padded (b, s, h, hd) inputs.
    Returns (O in q.dtype, lse fp32 (b, h, s_q))."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], k.shape[1], kv_len, causal=causal, q_offset=q_offset,
                 device=q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # masked probabilities are zeroed explicitly: a fully masked row has
    # m == NEG_INF and would otherwise average V instead of giving 0
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / torch.where(l == 0.0, 1.0, l).transpose(1, 2)
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain fp32 torch, on any device.

    q: (b, s_q, h, hd); k, v: (b, s_k, h, hd); kv_len: optional (b,) int
    true key lengths; q_offset: global position of q[0].  Returns
    (O (b, s_q, h, hd) in q.dtype, lse (b, h, s_q) fp32)."""
    _check_shapes(q, k, v, kv_len)
    s_q = q.shape[1]
    qp, kp, vp, kvl = _pad_inputs(q, k, v, kv_len)
    o, lse = _plain_core(qp, kp, vp, kvl, scale=scale, causal=causal,
                         q_offset=q_offset)
    return o[:, :s_q], lse[..., :s_q]


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, scale: float, causal: bool = True,
                              kv_len: Optional[torch.Tensor] = None, q_offset: int = 0):
    """The backward kernels' function (``_bwd``, ``flash_attention.py:326-400``)
    in plain fp32 torch, on any device: di = rowsum(O dO), P = exp(S - lse)
    with masked entries zeroed (so a fully masked row gives finite zero
    gradients), dS = P (dP - di), and dK, dQ carrying the scale.

    q, o, do: (b, s_q, h, hd); k, v: (b, s_k, h, hd); lse: (b, h, s_q) fp32
    from the forward.  Returns fp32 (dq, dk, dv) in their inputs' shapes."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _mask(q.shape[1], k.shape[1], kv_len, causal=causal, q_offset=q_offset,
                 device=q.device)
    # exp of a masked score may overflow (lse ~ NEG_INF on a fully masked
    # row): where() picks the zero, as the kernels' explicit masking does
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    di = (of * dof).sum(-1).transpose(1, 2)  # (b, h, s_q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq, dk, dv


@functools.cache
def _kernel_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_flash_attn_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 6 + [i32] * 5 + [i64] * 12
                   + [ctypes.c_float, i32, i32, ptr])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgmma_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_flash_attn_fwd_wgmma
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # q, k, v, o, lse, kv_len, b, h, s_q, s_k, hd, strides, scale, causal,
    # q_offset, stream
    fn.argtypes = [ptr] * 6 + [i32] * 5 + [ptr, ctypes.c_float, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, k, v, kv_len, q_offset, named):
    """The kernels' contract: bf16 CUDA tensors on q's device read as 16-byte
    cp.async rows (K1's mma.sync body) or through TMA tensor maps (K1's
    wgmma body, K9a, K9b): a unit
    head_dim stride, other strides multiples of 8 elements, a 16-byte
    aligned base; head_dim 128 or 256, q_offset >= 0, an int32 kv_len on
    the same device.  Returns kv_len contiguous."""
    _check_shapes(q, k, v, kv_len)
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if (t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a unit head_dim stride, strides that "
                             f"are multiples of 8 and a 16-byte aligned base, "
                             f"got strides {t.stride()}")
    hd = q.shape[3]
    if hd not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA flash kernels are built for head_dim {KERNEL_HEAD_DIMS}, got {hd}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if kv_len is not None:
        if kv_len.device != q.device or kv_len.dtype != torch.int32:
            raise TypeError(f"kv_len must be int32 on {q.device}, got "
                            f"{kv_len.dtype} on {kv_len.device}")
        kv_len = kv_len.contiguous()
    return kv_len


def _fwd_launch(wgmma, q, k, v, kv_len, *, scale, causal, q_offset):
    """Launch one body of K1 (the wgmma body if ``wgmma``) on inputs that
    ``_check_kernel_inputs`` passed, unless b h s_q is 0; counts nothing.
    Returns (O (b, s_q, h, hd) bf16, lse (b, h, s_q) fp32)."""
    b, s_q, h, hd = q.shape
    s_k = k.shape[1]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    if b * h * s_q == 0:
        return o, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if kv_len is None else kv_len.data_ptr())
    tail = (float(scale), int(bool(causal)), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
    if wgmma:
        strides = (ctypes.c_longlong * 9)(*(st for t in (q, k, v) for st in t.stride()[:3]))
        err = _wgmma_fn()(*ptrs, b, h, s_q, s_k, hd, strides, *tail)
        if err == -1:
            raise RuntimeError("flash attention (wgmma body): a tensor map did not encode")
    else:
        err = _kernel_fn()(*ptrs, b, h, s_q, s_k, hd, *q.stride()[:3], *k.stride()[:3],
                           *v.stride()[:3], *o.stride()[:3], *tail)
    if err != 0:
        body = "wgmma" if wgmma else "mma.sync"
        raise RuntimeError(f"flash attention kernel ({body} body) launch failed: cudaError {err}")
    return o, lse


def flash_attention_kernel(q, k, v, kv_len, *, scale, causal, q_offset):
    """Launch K1 on CUDA tensors (b, s, h, hd) bf16: the body that
    ``flash_fwd_takes_wgmma`` names for these shapes.

    Raises on anything the kernel does not take; never falls back.
    Returns (O (b, s_q, h, hd) bf16, lse (b, h, s_q) fp32).  Each launch
    adds one to ``flash_attention_kernel.launches``, and a launch of the
    wgmma body also to ``flash_attention_kernel.wgmma_launches``."""
    with obs.span("kernel.flash_fwd", M=q.shape[0] * q.shape[1]):
        kv_len = _check_kernel_inputs(q, k, v, kv_len, q_offset, (("q", q), ("k", k), ("v", v)))
        b, s_q, h, hd = q.shape
        wgmma = flash_fwd_takes_wgmma(b, h, s_q, k.shape[1], hd)
        o, lse = _fwd_launch(wgmma, q, k, v, kv_len, scale=scale, causal=causal, q_offset=q_offset)
    if b * h * s_q:
        flash_attention_kernel.launches += 1
        flash_attention_kernel.wgmma_launches += int(wgmma)
    return o, lse


flash_attention_kernel.launches = 0
flash_attention_kernel.wgmma_launches = 0


@functools.cache
def _bwd_fns():
    from magma_tpu_torch.cuda_build import load_library

    lib = load_library()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # q, k, v, dO, lse, di, outputs..., kv_len, b, h, s_q, s_k, hd, strides,
    # scale, causal, q_offset, stream
    tail = [ptr, i32, i32, i32, i32, i32, ptr, f32, i32, i32, ptr]
    dkv, dq = lib.magma_flash_attn_bwd_dkv, lib.magma_flash_attn_bwd_dq
    dkv.argtypes = [ptr] * 8 + tail
    dq.argtypes = [ptr] * 7 + tail
    dkv.restype = dq.restype = ctypes.c_int
    return dkv, dq


def _bwd_args(q, k, v, do, lse, di):
    """Check lse and di ((b, h, s_q) fp32 contiguous on q's device) and return
    the 12 (b, s, h) strides of q, k, v, dO as a C array."""
    b, s_q, h, _ = q.shape
    for name, t in (("lse", lse), ("di", di)):
        if (t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (b, h, s_q)):
            raise ValueError(f"{name} must be contiguous fp32 ({b}, {h}, {s_q}) on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    strides = [st for t in (q, k, v, do) for st in t.stride()[:3]]
    return (ctypes.c_longlong * 12)(*strides)


def flash_attention_bwd_dkv_kernel(q, k, v, do, lse, di, kv_len, *, scale, causal, q_offset):
    """K9a: launch ``csrc/flash_attn_bwd.cu``'s dK/dV kernel on CUDA tensors.
    q, dO (b, s_q, h, hd) and k, v (b, s_k, h, hd) bf16; lse and di (b, h,
    s_q) fp32.  Returns (dk, dv) contiguous bf16.  Raises on anything the
    kernel does not take.  Each launch adds one to ``.launches``."""
    with obs.span("kernel.flash_bwd_dkv", M=q.shape[0] * q.shape[1]):
        if do.shape != q.shape:
            raise ValueError(f"dO {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
        kv_len = _check_kernel_inputs(q, k, v, kv_len, q_offset,
                                      (("q", q), ("k", k), ("v", v), ("dO", do)))
        strides = _bwd_args(q, k, v, do, lse, di)
        b, s_q, h, hd = q.shape
        dk = torch.empty(k.shape, dtype=torch.bfloat16, device=q.device)
        dv = torch.empty(k.shape, dtype=torch.bfloat16, device=q.device)
        err = _bwd_fns()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), b, h, s_q, k.shape[1], hd, strides,
            float(scale), int(bool(causal)), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash attention dK/dV kernel launch failed: cudaError {err}")
    flash_attention_bwd_dkv_kernel.launches += 1
    return dk, dv


def flash_attention_bwd_dq_kernel(q, k, v, do, lse, di, kv_len, *, scale, causal, q_offset):
    """K9b: launch ``csrc/flash_attn_bwd.cu``'s dQ kernel, inputs as
    ``flash_attention_bwd_dkv_kernel``.  Returns dq contiguous bf16.  Each
    launch adds one to ``.launches``."""
    with obs.span("kernel.flash_bwd_dq", M=q.shape[0] * q.shape[1]):
        if do.shape != q.shape:
            raise ValueError(f"dO {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
        kv_len = _check_kernel_inputs(q, k, v, kv_len, q_offset,
                                      (("q", q), ("k", k), ("v", v), ("dO", do)))
        strides = _bwd_args(q, k, v, do, lse, di)
        b, s_q, h, hd = q.shape
        dq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
        err = _bwd_fns()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), b, h, s_q, k.shape[1], hd, strides,
            float(scale), int(bool(causal)), int(q_offset),
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash attention dQ kernel launch failed: cudaError {err}")
    flash_attention_bwd_dq_kernel.launches += 1
    return dq


flash_attention_bwd_dkv_kernel.launches = 0
flash_attention_bwd_dq_kernel.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool = True,
                        kv_len: Optional[torch.Tensor] = None, q_offset: int = 0):
    """(dq, dk, dv) in the dtypes of q, k, v: on CUDA tensors di = rowsum(O
    dO) in fp32 (outside the kernels, as in the JAX package), then K9a and
    K9b; on CPU tensors ``flash_attention_bwd_plain``."""
    if not q.is_cuda:
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale, causal=causal,
                                               kv_len=kv_len, q_offset=q_offset)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if do.stride(3) != 1 or any(st % 8 for st in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(scale=scale, causal=causal, q_offset=q_offset)
    dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, di, kv_len, **kw)
    dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, di, kv_len, **kw)
    return dq, dk, dv


def _forward(q, k, v, kv_len, *, scale, causal, q_offset):
    """(O, lse) of padded inputs: K1 on CUDA tensors, the plain math on CPU
    ones."""
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, kv_len, scale=scale, causal=causal,
                                      q_offset=q_offset)
    return _plain_core(q, k, v, kv_len, scale=scale, causal=causal, q_offset=q_offset)


class _Flash(torch.autograd.Function):
    """O of padded (b, s, h, hd) inputs: forward K1 (the plain forward on
    CPU tensors), saving (q, k, v, kv_len, O, lse); backward K9a + K9b (the
    plain backward on CPU tensors), as the JAX package's ``_flash``
    custom VJP (``flash_attention.py:408-434``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, scale, causal, q_offset):
        ctx.kw = dict(scale=scale, causal=causal, q_offset=q_offset)
        o, lse = _forward(q, k, v, kv_len, **ctx.kw)
        ctx.save_for_backward(q, k, v, kv_len, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_len, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, kv_len=kv_len, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _padded(q, k, v, kv_len):
    _check_shapes(q, k, v, kv_len)
    qp, kp, vp, kvl = _pad_inputs(q, k, v, kv_len)
    if kvl is not None and q.is_cuda:
        kvl = kvl.to(device=q.device, dtype=torch.int32)
    return qp, kp, vp, kvl


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward over (b, s, h, hd) tensors, returning (O, lse (b, h,
    s_q) fp32), not differentiable.  CUDA tensors run the kernel (or
    raise); CPU tensors run the plain version."""
    s_q = q.shape[1]
    o, lse = _forward(*_padded(q, k, v, kv_len), scale=scale, causal=causal, q_offset=q_offset)
    return o[:, :s_q], lse[..., :s_q]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    kv_len: Optional[torch.Tensor] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention over (b, s, h, hd) tensors; returns O, differentiable
    in q, k and v (K9a + K9b on the card).

    kv_len: optional (b,) true key lengths of right-padded rows.
    q_offset: global position of q[0] (static int)."""
    s_q = q.shape[1]
    o = _Flash.apply(*_padded(q, k, v, kv_len), float(scale), bool(causal), int(q_offset))
    return o[:, :s_q]
