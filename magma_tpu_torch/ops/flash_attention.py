"""Flash-attention forward: the CUDA kernel, its wrapper and its plain version.

Port of the forward of ``magma_tpu/ops/flash_attention.py`` (the Pallas
``_fwd_kernel``).  The kernel is ``csrc/flash_attn_fwd.cu``; its header
says what bounds it and how it is built.

* ``flash_attention`` / ``flash_attention_fwd`` -- the public entries over
  (b, s, h, hd) tensors.  On CUDA tensors they launch the kernel or raise;
  on CPU tensors they run ``flash_attention_plain``'s math.  Which one runs
  depends only on the device of the tensors given.
* ``flash_attention_plain`` -- the same masked online-softmax function in
  fp32 torch, on any device.  The CPU tests hold it against the JAX
  kernel, and ``chip_smoke.py`` holds the kernel against it.

Both keep the JAX wrapper's padding (``flash_attention.py:458-469``):
sequences pad up to a multiple of 128, padded keys are masked through
``kv_len`` (set to the true key length when the caller gave none) and
padded query rows are cut from the output.  The backward (the JAX
package's custom VJP) is not ported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from magma_tpu_torch.ops.attention import NEG_INF

SEQ_ALIGN = 128                  # the JAX wrapper's padding unit
KERNEL_HEAD_DIMS = (128, 256)    # head dims the CUDA kernel is built for


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


def _plain_core(q, k, v, kv_len, *, scale, causal, q_offset):
    """Masked softmax attention in fp32 over padded (b, s, h, hd) inputs.
    Returns (O in q.dtype, lse fp32 (b, h, s_q))."""
    s_q, s_k = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((1, 1, s_q, s_k), dtype=torch.bool, device=q.device)
    cols = torch.arange(s_k, device=q.device)
    if causal:
        rows = torch.arange(s_q, device=q.device)[:, None] + q_offset
        mask = mask & (cols[None, :] <= rows)[None, None]
    if kv_len is not None:
        mask = mask & (cols[None, :] < kv_len.to(q.device)[:, None])[:, None, None, :]
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


@functools.cache
def _kernel_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_flash_attn_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 6 + [i32] * 5 + [i64] * 12
                   + [ctypes.c_float, i32, i32, ptr])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q, k, v, kv_len, *, scale, causal, q_offset):
    """Launch ``csrc/flash_attn_fwd.cu`` on CUDA tensors (b, s, h, hd) bf16.

    Raises on anything the kernel does not take; never falls back.
    Returns (O (b, s_q, h, hd) bf16, lse (b, h, s_q) fp32).  Each launch
    adds one to ``flash_attention_kernel.launches``."""
    _check_shapes(q, k, v, kv_len)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        # 16-byte cp.async rows: unit head_dim stride, 8-element strides,
        # a 16-byte aligned base
        if (t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a unit head_dim stride, strides that "
                             f"are multiples of 8 and a 16-byte aligned base, "
                             f"got strides {t.stride()}")
    b, s_q, h, hd = q.shape
    s_k = k.shape[1]
    if hd not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"the CUDA flash kernel is built for head_dim {KERNEL_HEAD_DIMS}, got {hd}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if kv_len is not None:
        if kv_len.device != q.device or kv_len.dtype != torch.int32:
            raise TypeError(f"kv_len must be int32 on {q.device}, got "
                            f"{kv_len.dtype} on {kv_len.device}")
        kv_len = kv_len.contiguous()
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    if b * h * s_q == 0:
        return o, lse
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(),
        b, h, s_q, s_k, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        float(scale), int(bool(causal)), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    flash_attention_kernel.launches += 1
    return o, lse


flash_attention_kernel.launches = 0


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
    """Flash attention over (b, s, h, hd) tensors, returning (O, lse (b, h,
    s_q) fp32).  CUDA tensors run the kernel (or raise); CPU tensors run
    the plain version."""
    _check_shapes(q, k, v, kv_len)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     kv_len=kv_len, q_offset=q_offset)
    s_q = q.shape[1]
    qp, kp, vp, kvl = _pad_inputs(q, k, v, kv_len)
    if kvl is not None:
        kvl = kvl.to(device=q.device, dtype=torch.int32)
    o, lse = flash_attention_kernel(qp, kp, vp, kvl, scale=scale, causal=causal,
                                    q_offset=q_offset)
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
    """Flash attention over (b, s, h, hd) tensors; returns O.

    kv_len: optional (b,) true key lengths of right-padded rows.
    q_offset: global position of q[0] (static int)."""
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                               kv_len=kv_len, q_offset=q_offset)[0]
