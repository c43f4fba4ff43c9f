"""Weight-only int8: quantisation, the CUDA kernels' wrappers and their
plain versions.

Port of the int8 parts of ``magma_tpu/ops/quant.py``: ``quantize_int8``,
``quantize_adapter_fused``, and the four products the int8 serving decode
runs per layer and per token.

* ``int8_matmul`` (K2a, the untied head) and ``int8_matmul_stacked`` (K2b,
  the fused [q|k|v|fc_in] in_proj): x (M, K) @ int8 W (K, N), the
  per-column scale applied to the fp32 accumulator.
* ``dual_matmul_stacked`` (K4a): o_proj and fc_out over the K-concatenated
  [W_o; W_f] stream in one launch, two outputs.
* ``fused_adapter_stacked`` (K5): up(relu(down(x))) of the int8 bottleneck
  adapter in one launch for m <= 64 rows.

The kernels are ``csrc/int8_matmul.cu`` (K2a, K2b, K4a) and
``csrc/fused_adapter.cu`` (K5); their headers say what bounds them.  Each
public function takes the kernel on CUDA tensors (launching it, or raising
on what it does not take) and its ``*_plain`` twin on CPU tensors; only
``fused_adapter_stacked`` above 64 rows (prefill) takes the dequantising
bf16 matmuls on either device, as the JAX package does.  The
plain versions compute the kernels' function in fp32 torch on any device:
the dequantised weight times the activations, the scale applied to the
product.  The int4 payloads (``q4``) wait for the int4 slice of the port.

A layer of a stacked payload is a view ``w[idx]``, so the stacked entries
pass the layer's base pointer and share the 2-D kernels' code.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

FUSED_ADAPTER_MAX_ROWS = 64   # m above this (prefill) takes the dequantising matmul
KERNEL_ALIGN = 128            # K and N must be multiples of this, as in JAX
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # fp32(1/127)


# ---------------------------------------------------------------------------
# Quantisation (byte-identical to the JAX package)
# ---------------------------------------------------------------------------


def quantize_int8(w: torch.Tensor, *, compiled: bool = False) -> Dict[str, torch.Tensor]:
    """(..., K, N) weights -> {"q": int8, "s": fp32 per output channel
    (..., N)}: symmetric, scale = max|w[:, n]| / 127.  Leading (layer)
    dims are kept; both come back contiguous, whatever the strides of w
    (the head quantizes a transposed view of ``wte``).

    ``compiled=True`` gives the bytes of the JAX function under
    ``jax.jit`` (as ``gptj.quantize_lm_params`` runs it), where XLA turns
    the division by 127 into a product with fp32(1/127): the scale then
    differs from the eager one in the last bit for some columns."""
    w = w.float()
    amax = torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-8)
    scale = amax * _INV_127 if compiled else amax / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "s": scale[..., 0, :].contiguous()}


def quantize_adapter_fused(down_kernel, down_bias, up_kernel, up_bias,
                           out_scale=None) -> Optional[Dict[str, torch.Tensor]]:
    """Pack a stacked adapter bottleneck (down (L, D, DH) + bias (L, DH),
    up (L, DH, D) + bias (L, D)) for ``fused_adapter_stacked``: int8 "wd",
    "wu" and fp32 (L, 1, n) "sd", "bd", "su", "bu".  ``out_scale`` (L,)
    is the scaled_parallel scalar, folded into the up scales and bias.
    Returns None when D or DH is not a multiple of 128 (callers keep bf16)."""
    L, D, DH = down_kernel.shape
    if D % KERNEL_ALIGN or DH % KERNEL_ALIGN:
        return None
    qd = quantize_int8(down_kernel)
    qu = quantize_int8(up_kernel)
    su = qu["s"].reshape(L, 1, D)
    bu = up_bias.float().reshape(L, 1, D)
    if out_scale is not None:
        sc = out_scale.float().reshape(L, 1, 1)
        su = su * sc
        bu = bu * sc
    return {
        "wd": qd["q"],
        "sd": qd["s"].reshape(L, 1, DH),
        "bd": down_bias.float().reshape(L, 1, DH),
        "wu": qu["q"],
        "su": su,
        "bu": bu,
    }


# ---------------------------------------------------------------------------
# Plain versions: the kernels' functions in fp32 torch, on any device
# ---------------------------------------------------------------------------


def _dq_product(x2: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(M, K) @ int8 (K, N) in fp32, times the (N,) scale."""
    return (x2.float() @ wq.float()) * s.float()


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ wq (K, N) * scales (N,) -> fp32 (..., N)."""
    lead = x.shape[:-1]
    return _dq_product(x.reshape(-1, x.shape[-1]), wq, scales).reshape(*lead, wq.shape[-1])


def int8_matmul_stacked_plain(x, wq, scales, layer_idx: int) -> torch.Tensor:
    """Layer ``layer_idx`` of stacked wq (L, K, N), scales (L, N)."""
    return int8_matmul_plain(x, wq[layer_idx], scales[layer_idx])


def dual_matmul_stacked_plain(ctx, h, w: Dict, layer_idx: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ctx @ W[:Ko] * s[0], h @ W[Ko:] * s[1]) for layer ``layer_idx`` of
    the K-concatenated payload {"q": (L, Ko + Kf, N), "s": (L, 2, N)}."""
    q, s = w["q"][layer_idx], w["s"][layer_idx]
    ko = ctx.shape[-1]
    return int8_matmul_plain(ctx, q[:ko], s[0]), int8_matmul_plain(h, q[ko:], s[1])


def fused_adapter_stacked_plain(x, fz: Dict, layer_idx: int) -> torch.Tensor:
    """The K5 kernel's function: x rounded to bf16, h = relu((x @ Wd) * sd
    + bd) rounded to bf16, then (h @ Wu) * su + bu, fp32 (..., D)."""
    lead, D = x.shape[:-1], x.shape[-1]
    li = layer_idx
    x2 = x.reshape(-1, D).to(torch.bfloat16)
    h = torch.relu(_dq_product(x2, fz["wd"][li], fz["sd"][li, 0])
                   + fz["bd"][li, 0].float())
    h = h.to(torch.bfloat16)
    out = _dq_product(h, fz["wu"][li], fz["su"][li, 0]) + fz["bu"][li, 0].float()
    return out.reshape(*lead, D)


def _fused_adapter_dequant(x, fz: Dict, layer_idx: int) -> torch.Tensor:
    """The m > 64 path (``quant.py:919-931``): weights dequantised and
    rounded to bf16, two bf16 products with fp32 accumulation.  A plain
    large product outside any kernel, as the JAX package leaves it to XLA."""
    lead, D = x.shape[:-1], x.shape[-1]
    li = layer_idx
    wd = (fz["wd"][li].float() * fz["sd"][li]).to(torch.bfloat16)
    wu = (fz["wu"][li].float() * fz["su"][li]).to(torch.bfloat16)
    x2 = x.reshape(-1, D).to(torch.bfloat16)
    h = torch.relu(_bf16_mm_f32(x2, wd) + fz["bd"][li, 0])
    out = _bf16_mm_f32(h.to(torch.bfloat16), wu) + fz["bu"][li, 0]
    return out.reshape(*lead, D)


def _bf16_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 @ bf16 accumulated and returned in fp32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only; raise on what the kernels do not take)
# ---------------------------------------------------------------------------


@functools.cache
def _int8_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_int8_matmul
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    seg = [ptr, i64, ptr, ptr, ptr, i32]  # x, ldx, w, s, out, K
    fn.argtypes = [i32, i32, i32] + seg + seg + [ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _adapter_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_fused_adapter
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _check_rows(name: str, t: torch.Tensor) -> None:
    """2-D with at least one row, unit last stride, a row stride that is a
    multiple of 8 elements and a 16-byte aligned base (16-byte loads of
    whole rows)."""
    if t.dim() != 2 or t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name} must be 2-D with a unit last stride, a row stride "
                         f"that is a multiple of 8 and a 16-byte aligned base, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    if t.shape[0] == 0:
        raise ValueError(f"{name} has no rows: the kernels take at least one")


def _check_weight(name: str, w: torch.Tensor, s: torch.Tensor, k: int, device) -> int:
    """int8 (K, N) contiguous with N and K multiples of 128; fp32 (N,)
    contiguous scales.  Returns N."""
    _check_cuda(name, w, torch.int8, device)
    _check_cuda(f"{name} scales", s, torch.float32, device)
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"{name} must be ({k}, N), got {tuple(w.shape)}")
    n = w.shape[1]
    if k % KERNEL_ALIGN or n % KERNEL_ALIGN:
        raise ValueError(f"{name}: K and N must be multiples of {KERNEL_ALIGN}, "
                         f"got K={k}, N={n}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous with a 16-byte aligned base")
    if tuple(s.shape) != (n,) or not s.is_contiguous():
        raise ValueError(f"{name} scales must be contiguous ({n},), got {tuple(s.shape)}")
    return n


def _launch_int8(segments, m: int, n: int, device) -> None:
    """One launch of ``csrc/int8_matmul.cu`` over one or two segments of
    (x (M, K) bf16, w (K, N) int8, s (N,) fp32, out (M, N) fp32)."""
    args = []
    for x, w, s, out in segments:
        args += [x.data_ptr(), x.stride(0), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                 x.shape[1]]
    if len(segments) == 1:
        args += [None, 0, None, None, None, 0]
    err = _int8_fn()(len(segments), m, n, *args,
                     torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 matmul kernel launch failed: cudaError {err}")


def _int8_single(x2: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    _check_cuda("x", x2, torch.bfloat16, None)
    _check_rows("x", x2)
    n = _check_weight("w", wq, s, x2.shape[1], x2.device)
    out = torch.empty((x2.shape[0], n), dtype=torch.float32, device=x2.device)
    _launch_int8([(x2, wq, s, out)], x2.shape[0], n, x2.device)
    return out


def int8_matmul_kernel(x2: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K2a: x2 (M, K) bf16 @ wq (K, N) int8 * s (N,) -> fp32 (M, N), on the
    card.  Each launch adds one to ``int8_matmul_kernel.launches``."""
    out = _int8_single(x2, wq, s)
    int8_matmul_kernel.launches += 1
    return out


def int8_matmul_stacked_kernel(x2: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                               layer_idx: int) -> torch.Tensor:
    """K2b: layer ``layer_idx`` of stacked wq (L, K, N), s (L, N), read in
    place through the layer's view.  Counts in
    ``int8_matmul_stacked_kernel.launches``."""
    if wq.dim() != 3 or s.dim() != 2:
        raise ValueError(f"stacked weights must be (L, K, N) with (L, N) scales, got "
                         f"{tuple(wq.shape)}, {tuple(s.shape)}")
    out = _int8_single(x2, wq[layer_idx], s[layer_idx])
    int8_matmul_stacked_kernel.launches += 1
    return out


def dual_matmul_kernel(c2: torch.Tensor, h2: torch.Tensor, wq: torch.Tensor,
                       s: torch.Tensor, layer_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4a: (c2 @ W[:Ko] * s[0], h2 @ W[Ko:] * s[1]) for layer ``layer_idx``
    of wq (L, Ko + Kf, N) int8, s (L, 2, N) fp32, in one launch.  Counts in
    ``dual_matmul_kernel.launches``."""
    for name, t in (("ctx", c2), ("h", h2)):
        _check_cuda(name, t, torch.bfloat16, c2.device)
        _check_rows(name, t)
    if c2.shape[0] != h2.shape[0]:
        raise ValueError(f"ctx and h differ in rows: {c2.shape[0]} vs {h2.shape[0]}")
    if wq.dim() != 3 or s.dim() != 3 or s.shape[1] != 2:
        raise ValueError(f"dual payload must be q (L, Ko+Kf, N), s (L, 2, N), got "
                         f"{tuple(wq.shape)}, {tuple(s.shape)}")
    ko, kf = c2.shape[1], h2.shape[1]
    wl, sl = wq[layer_idx], s[layer_idx]
    if wl.shape[0] != ko + kf:
        raise ValueError(f"payload has {wl.shape[0]} rows, ctx + h give {ko + kf}")
    n = _check_weight("w_o", wl[:ko], sl[0], ko, c2.device)
    _check_weight("w_f", wl[ko:], sl[1], kf, c2.device)
    m = c2.shape[0]
    a = torch.empty((m, n), dtype=torch.float32, device=c2.device)
    mo = torch.empty((m, n), dtype=torch.float32, device=c2.device)
    _launch_int8([(c2, wl[:ko], sl[0], a), (h2, wl[ko:], sl[1], mo)], m, n, c2.device)
    dual_matmul_kernel.launches += 1
    return a, mo


def fused_adapter_kernel(x2: torch.Tensor, fz: Dict, layer_idx: int) -> torch.Tensor:
    """K5: the whole int8 bottleneck of layer ``layer_idx`` for x2 (m, D)
    bf16, m <= 64, in one cooperative launch -> fp32 (m, D).  Counts in
    ``fused_adapter_kernel.launches``."""
    _check_cuda("x", x2, torch.bfloat16, None)
    _check_rows("x", x2)
    m, d = x2.shape
    if m > FUSED_ADAPTER_MAX_ROWS:
        raise ValueError(f"the fused adapter kernel takes 1..{FUSED_ADAPTER_MAX_ROWS} "
                         f"rows, got {m}")
    li = layer_idx
    wd, wu = fz["wd"][li], fz["wu"][li]
    vecs = {k: fz[k][li].reshape(-1) for k in ("sd", "bd", "su", "bu")}
    dh = _check_weight("wd", wd, vecs["sd"], d, x2.device)
    if _check_weight("wu", wu, vecs["su"], dh, x2.device) != d:
        raise ValueError(f"wu must be ({dh}, {d}), got {tuple(wu.shape)}")
    for k, n in (("bd", dh), ("bu", d)):
        _check_cuda(k, vecs[k], torch.float32, x2.device)
        if tuple(vecs[k].shape) != (n,) or not vecs[k].is_contiguous():
            raise ValueError(f"{k} must be contiguous ({n},), got {tuple(vecs[k].shape)}")
    h = torch.empty((m, dh), dtype=torch.bfloat16, device=x2.device)  # the phase boundary
    out = torch.empty((m, d), dtype=torch.float32, device=x2.device)
    err = _adapter_fn()(
        x2.data_ptr(), wd.data_ptr(), vecs["sd"].data_ptr(), vecs["bd"].data_ptr(),
        wu.data_ptr(), vecs["su"].data_ptr(), vecs["bu"].data_ptr(), h.data_ptr(),
        out.data_ptr(), m, d, dh, torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused adapter kernel launch failed: cudaError {err}")
    fused_adapter_kernel.launches += 1
    return out


for _fn in (int8_matmul_kernel, int8_matmul_stacked_kernel, dual_matmul_kernel,
            fused_adapter_kernel):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# Public entries: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(..., K) -> contiguous bf16 (M, K): the kernels read x as bf16, as
    the Pallas kernels cast it (``x_ref[...].astype(bf16)``)."""
    return x.reshape(-1, x.shape[-1]).to(torch.bfloat16).contiguous()


def _cast(t: torch.Tensor, out_dtype) -> torch.Tensor:
    return t if out_dtype is None else t.to(out_dtype)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x (..., K) @ dequant(wq (K, N), scales (N,)) -> (..., N), fp32 unless
    ``out_dtype``."""
    if not x.is_cuda:
        return _cast(int8_matmul_plain(x, wq, scales), out_dtype)
    out = int8_matmul_kernel(_rows(x), wq, scales)
    return _cast(out.reshape(*x.shape[:-1], wq.shape[-1]), out_dtype)


def int8_matmul_stacked(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
                        layer_idx: int, out_dtype=None) -> torch.Tensor:
    """x (..., K) @ layer ``layer_idx`` of stacked int8 wq (L, K, N) with
    scales (L, N)."""
    if not x.is_cuda:
        return _cast(int8_matmul_stacked_plain(x, wq, scales, layer_idx), out_dtype)
    out = int8_matmul_stacked_kernel(_rows(x), wq, scales, layer_idx)
    return _cast(out.reshape(*x.shape[:-1], wq.shape[-1]), out_dtype)


def dual_matmul_stacked(ctx: torch.Tensor, h: torch.Tensor, w: Dict, layer_idx: int,
                        out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ctx @ W_o`` and ``h @ W_f`` of layer ``layer_idx`` in one launch,
    over the payload {"q": (L, Ko + Kf, N), "s": (L, 2, N)} that
    ``gptj.quantize_lm_params`` builds.  Returns (a, m), each (..., N):
    separate, because the per-branch adapters need them apart."""
    if "q4" in w:
        raise NotImplementedError(
            "int4 dual payloads (q4) arrive with the int4 slice of the port (K4b)")
    lead, n = ctx.shape[:-1], w["q"].shape[-1]
    if not ctx.is_cuda:
        a, m = dual_matmul_stacked_plain(ctx, h, w, layer_idx)
    else:
        a, m = dual_matmul_kernel(_rows(ctx), _rows(h), w["q"], w["s"], layer_idx)
    return _cast(a.reshape(*lead, n), out_dtype), _cast(m.reshape(*lead, n), out_dtype)


def fused_adapter_stacked(x: torch.Tensor, fz: Dict, layer_idx: int,
                          out_dtype=None) -> torch.Tensor:
    """x (..., D) -> up(relu(down(x) * sd + bd)) * su + bu for layer
    ``layer_idx`` of the payload ``quantize_adapter_fused`` builds.  Up to
    64 rows (decode) take K5, one launch; more rows (prefill) take the
    dequantising bf16 matmuls, as in the JAX package."""
    lead, D = x.shape[:-1], x.shape[-1]
    m = x[..., 0].numel()
    if m > FUSED_ADAPTER_MAX_ROWS:
        return _cast(_fused_adapter_dequant(x, fz, layer_idx), out_dtype)
    if not x.is_cuda:
        return _cast(fused_adapter_stacked_plain(x, fz, layer_idx), out_dtype)
    out = fused_adapter_kernel(_rows(x), fz, layer_idx)
    return _cast(out.reshape(*lead, D), out_dtype)
