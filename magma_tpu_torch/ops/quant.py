"""Weight-only int8 and int4: quantisation, the CUDA kernels' wrappers and
their plain versions.

Port of ``magma_tpu/ops/quant.py``'s serving products.  int8
(``quantize_int8``, ``quantize_adapter_fused``):

* ``int8_matmul`` (K2a, the untied head) and ``int8_matmul_stacked`` (K2b,
  the fused [q|k|v|fc_in] in_proj; in the QLoRA layout also o and fc_out):
  x (M, K) @ int8 W (K, N), the per-column scale applied to the fp32
  accumulator.  Both are differentiable in x through a
  ``torch.autograd.Function`` whose backward is K10
  (``int8_matmul_dx_kernel``, ``csrc/int8_matmul_dx.cu``): dx = bf16(g s)
  @ W^T read from the stored (K, N) layout; no gradient for the weights.
* ``dual_matmul_stacked`` (K4a): o_proj and fc_out over the K-concatenated
  [W_o; W_f] stream in one launch, two outputs.
* ``fused_adapter_stacked`` (K5): up(relu(down(x))) of the int8 bottleneck
  adapter in one launch for m <= 64 rows.

int4 (``quantize_int4``: nibble-packed, 256-row group scales), computed
W4A8 as the TPU kernels compute it: activations quantised to int8 per
(row, 256-column block) (``quantize_act_block``), int8 x int8 dots exact
in int32, both scales folded onto the fp32 sum group by group:

* ``int4_matmul_stacked`` (K3) and the ``q4`` branch of
  ``dual_matmul_stacked`` (K4b);
* ``boundary_fused_stacked`` (K6): everything between two decode
  attentions (dual, o_bias, adapters, residual, the next LN and the next
  layer's in_proj) in one launch for m <= 8 rows.

The kernels are ``csrc/int8_matmul.cu`` (K2a, K2b, K4a),
``csrc/fused_adapter.cu`` (K5), ``csrc/int4_matmul.cu`` (K3, K4b),
``csrc/boundary.cu`` (K6) and ``csrc/int8_matmul_dx.cu`` (K10); their
headers say what bounds them.  Each
public function takes the kernel on CUDA tensors (launching it, or raising
on what it does not take) and its ``*_plain`` twin on CPU tensors.  Off
the kernels' geometry the JAX package computes outside any kernel, and so
does the port, on either device: ``fused_adapter_stacked`` above 64 rows
takes the dequantising bf16 matmuls; the int4 products with a group other
than 256 (small test widths) take the dequantising fp32 product (W4A16);
``boundary_fused_stacked`` off its geometry takes the composition of the
public products.

A layer of a stacked payload is a view ``w[idx]``, so the stacked entries
pass the layer's base pointer and share the 2-D kernels' code.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Dict, Optional, Tuple

import torch

from magma_tpu_torch import observability as obs

FUSED_ADAPTER_MAX_ROWS = 64   # m above this (prefill) takes the dequantising matmul
KERNEL_ALIGN = 128            # K and N must be multiples of this, as in JAX
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # fp32(1/127)
INT4_GROUP = 256              # input rows per int4 group, and the W4A8 kernels' group
BOUNDARY_MAX_ROWS = 8         # K6 takes m <= 8 rows (the b <= 8 decode)
_INV_7 = torch.tensor(1.0 / 7.0, dtype=torch.float32).item()      # fp32(1/7)


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
    the K-concatenated payload {"q": (L, Ko + Kf, N), "s": (L, 2, N)}; for
    an int4 payload {"q4", "s4"} (K4b's function), the W4A8 product of
    each part (``_w4a8``)."""
    ko = ctx.shape[-1]
    if "q4" in w:
        (qo, so), (qf, sf) = _dual_int4_parts(w, layer_idx, ko)
        return _w4a8(ctx, qo, so), _w4a8(h, qf, sf)
    q, s = w["q"][layer_idx], w["s"][layer_idx]
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


def int8_matmul_dx_plain(g: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K10's function: the input gradient of x @ (wq (K, N) * scales (N,))
    for an output gradient g (M, N): (g * s) formed in fp32 and rounded to
    bf16, times the int8 codes (exact in bf16), contracted over N against
    the stored (K, N) layout and accumulated in fp32 -> fp32 (M, K).  As
    the Pallas kernel computes it (``quant.py:215-220``), not as JAX's CPU
    fallback (fp32 throughout)."""
    gs = (g.float() * scales.float()).to(torch.bfloat16).float()
    return gs @ wq.float().T


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
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [ptr] * 8 + [i64, ptr] + [i32] * 5 + [ptr, ptr]  # ..., stamps, stream
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
    with obs.span("kernel.int8", M=x2.shape[0]):
        out = _int8_single(x2, wq, s)
    int8_matmul_kernel.launches += 1
    return out


def int8_matmul_stacked_kernel(x2: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                               layer_idx: int) -> torch.Tensor:
    """K2b: layer ``layer_idx`` of stacked wq (L, K, N), s (L, N), read in
    place through the layer's view.  Counts in
    ``int8_matmul_stacked_kernel.launches``."""
    with obs.span("kernel.int8", M=x2.shape[0]):
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
    with obs.span("kernel.int8", M=c2.shape[0]):
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


def _round256(n: int) -> int:
    return -(-n // 256) * 256


def adapter_scratch_bytes(m: int, d: int, dh: int) -> int:
    """The scratch of one K5 launch (``csrc/fused_adapter.cu`` ``layout``,
    which refuses less): the launch's nonce and its arrival counters (the
    grid barrier's, one a column tile of the down product), the down
    product's fp32 chunk partials, h in bf16."""
    counters = 1 + dh // KERNEL_ALIGN
    terms = -(-d // 256) * m * dh
    return _round256(8 + 4 * counters) + _round256(4 * terms) + 2 * m * dh


def _layer_index(layer_idx, n_layers: int) -> int:
    """An integer layer index of an n_layers stack (negative from the end)."""
    li = _concrete_layer(layer_idx)
    if li is None or not -n_layers <= li < n_layers:
        raise ValueError(f"layer_idx={layer_idx!r} is not a layer of a {n_layers}-layer stack")
    return li % n_layers


def _check_stack(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    """A contiguous CUDA stack of ``dtype`` and ``shape`` on ``device`` (a
    CUDA device index) with a 16-byte aligned base: the kernels read its
    layers in place, so the check looks at the stack itself and makes no
    view of it."""
    if t.get_device() != device:
        raise ValueError(f"{name} must be a CUDA tensor on cuda:{device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != shape or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous {shape} stack with a 16-byte aligned "
                         f"base, got {tuple(t.shape)}")


def _stream(device_index: int) -> int:
    """The current CUDA stream of the device, as the raw handle a kernel
    launch takes."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _adapter_stacks(name: str, fz: Dict, d: int, device):
    """(L, DH) of a fused adapter payload whose stacks the kernels take:
    int8 wd (L, d, DH), wu (L, DH, d); fp32 sd, bd (L, 1, DH), su, bu (L, 1, d)."""
    wd = fz["wd"]
    if wd.dim() != 3:
        raise ValueError(f"{name} wd must be (L, {d}, DH), got {tuple(wd.shape)}")
    L, dh = wd.shape[0], wd.shape[2]
    if d % KERNEL_ALIGN or dh % KERNEL_ALIGN:
        raise ValueError(f"{name}: D and DH must be multiples of {KERNEL_ALIGN}, got {d}, {dh}")
    for key, dtype, shape in (("wd", torch.int8, (L, d, dh)), ("wu", torch.int8, (L, dh, d)),
                              ("sd", torch.float32, (L, 1, dh)), ("bd", torch.float32, (L, 1, dh)),
                              ("su", torch.float32, (L, 1, d)), ("bu", torch.float32, (L, 1, d))):
        _check_stack(f"{name} {key}", fz[key], dtype, shape, device)
    return L, dh


def _adapter_ptrs(fz: Dict, li: int, d: int, dh: int):
    """[wd, sd, bd, wu, su, bu] pointers: the weight stacks' bases (the
    kernel reads layer li through its tensor maps) and the layer's rows."""
    row = lambda t, n: t.data_ptr() + li * n * 4  # noqa: E731
    return [fz["wd"].data_ptr(), row(fz["sd"], dh), row(fz["bd"], dh), fz["wu"].data_ptr(),
            row(fz["su"], d), row(fz["bu"], d)]


ADAPTER_PHASES = ("down", "down sums", "up")  # K5's stamped phases, in order


def _adapter_launch(x2: torch.Tensor, fz: Dict, layer_idx: int, stamps=None) -> torch.Tensor:
    """One launch of ``csrc/fused_adapter.cu``: checks, the layer's pointers
    into the stacks, one scratch allocation.  Returns fp32 (m, D)."""
    _check_cuda("x", x2, torch.bfloat16, None)
    _check_rows("x", x2)
    m, d = x2.shape
    if m > FUSED_ADAPTER_MAX_ROWS:
        raise ValueError(f"the fused adapter kernel takes 1..{FUSED_ADAPTER_MAX_ROWS} "
                         f"rows, got {m}")
    if x2.stride(0) != d:
        raise ValueError("x must be contiguous")
    dev = x2.get_device()
    L, dh = _adapter_stacks("adapter", fz, d, dev)
    li = _layer_index(layer_idx, L)
    wd, sd, bd, wu, su, bu = _adapter_ptrs(fz, li, d, dh)
    n_scratch = adapter_scratch_bytes(m, d, dh)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=x2.device)
    out = torch.empty((m, d), dtype=torch.float32, device=x2.device)
    err = _adapter_fn()(x2.data_ptr(), wd, sd, bd, wu, su, bu, scratch.data_ptr(), n_scratch,
                        out.data_ptr(), m, d, dh, L, li,
                        None if stamps is None else stamps.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused adapter kernel launch failed: cudaError {err}")
    return out


def fused_adapter_kernel(x2: torch.Tensor, fz: Dict, layer_idx: int) -> torch.Tensor:
    """K5: the whole int8 bottleneck of layer ``layer_idx`` for x2 (m, D)
    bf16, m <= 64, in one cooperative launch -> fp32 (m, D).  Counts in
    ``fused_adapter_kernel.launches``."""
    with obs.span("kernel.adapter", M=x2.shape[0]):
        out = _adapter_launch(x2, fz, layer_idx)
    fused_adapter_kernel.launches += 1
    return out


def _grid_of(entry: str) -> int:
    """The grid a cooperative kernel launches on the current device."""
    from magma_tpu_torch.cuda_build import load_library

    blocks = ctypes.c_int(0)
    err = getattr(load_library(), entry)(ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    return blocks.value


def fused_adapter_stamped(x2: torch.Tensor, fz: Dict, layer_idx: int):
    """K5's stamped build, for measurement only (never on the main path and
    not counted in ``fused_adapter_kernel.launches``): the kernel's output,
    then int64 stamps (grid, len(ADAPTER_PHASES), 2) of each block's
    %globaltimer at each phase's start and end (0 where a block did not run
    a phase); ``phase_breakdown(stamps, ADAPTER_PHASES)`` reads them."""
    stamps = torch.zeros((_grid_of("magma_fused_adapter_grid"), len(ADAPTER_PHASES), 2),
                         dtype=torch.int64, device=x2.device)
    return _adapter_launch(x2, fz, layer_idx, stamps), stamps


@functools.cache
def _dx_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_int8_matmul_dx
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def int8_matmul_dx_kernel(g: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K10: g (M, N) fp32 contiguous, wq (K, N) int8, s (N,) fp32 -> dx (M, K)
    fp32 = bf16(g s) @ wq^T, on the card (``csrc/int8_matmul_dx.cu``),
    reading wq in its stored layout.  A layer of a stacked payload is passed
    as its view.  Each launch adds one to ``int8_matmul_dx_kernel.launches``."""
    with obs.span("kernel.int8_dx", M=g.shape[0]):
        _check_cuda("g", g, torch.float32, None)
        if g.dim() != 2 or not g.is_contiguous() or g.data_ptr() % 16 or g.shape[0] == 0:
            raise ValueError(f"g must be a contiguous 16-byte aligned (M, N) with M > 0, got "
                             f"shape {tuple(g.shape)} strides {g.stride()}")
        if wq.dim() != 2:
            raise ValueError(f"w must be (K, N), got {tuple(wq.shape)}")
        n = _check_weight("w", wq, s, wq.shape[0], g.device)
        if s.data_ptr() % 16:  # the kernel copies the scales with 16-byte bulk copies
            raise ValueError("w scales must have a 16-byte aligned base")
        if g.shape[1] != n:
            raise ValueError(f"g has {g.shape[1]} columns, w has N = {n}")
        m, k = g.shape[0], wq.shape[0]
        dx = torch.empty((m, k), dtype=torch.float32, device=g.device)
        err = _dx_fn()(g.data_ptr(), wq.data_ptr(), s.data_ptr(), dx.data_ptr(), m, n, k,
                       torch.cuda.current_stream(g.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"int8 matmul dx kernel launch failed: cudaError {err}")
    int8_matmul_dx_kernel.launches += 1
    return dx


for _fn in (int8_matmul_kernel, int8_matmul_stacked_kernel, dual_matmul_kernel,
            fused_adapter_kernel, int8_matmul_dx_kernel):
    _fn.launches = 0


def _int8_forward(x2, wq, s, layer):
    """x2 (M, K) @ w (K, N) * s (N,) -> fp32 (M, N): K2a (K2b for layer
    ``layer`` of a stacked payload) on CUDA tensors, the plain product on
    CPU ones."""
    if not x2.is_cuda:
        return _dq_product(x2, *((wq, s) if layer is None else (wq[layer], s[layer])))
    if layer is None:
        return int8_matmul_kernel(x2, wq, s)
    return int8_matmul_stacked_kernel(x2, wq, s, layer)


class _Int8Matmul(torch.autograd.Function):
    """``_int8_forward`` with backward K10 (its plain version on CPU
    tensors).  Gradient for x2 only, in x2's dtype: the int8 weights are
    frozen by contract, as in the JAX package's custom VJPs
    (``quant.py:268-356``)."""

    @staticmethod
    def forward(ctx, x2, wq, s, layer):
        ctx.save_for_backward(*((wq, s) if layer is None else (wq[layer], s[layer])))
        ctx.x_dtype = x2.dtype
        return _int8_forward(x2, wq, s, layer)

    @staticmethod
    def backward(ctx, g):
        wl, sl = ctx.saved_tensors
        g = g.float().contiguous()
        dx = int8_matmul_dx_kernel(g, wl, sl) if g.is_cuda else int8_matmul_dx_plain(g, wl, sl)
        return dx.to(ctx.x_dtype), None, None, None


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
    ``out_dtype``.  Differentiable in x (K10 on the card)."""
    x2 = _rows(x) if x.is_cuda else x.reshape(-1, x.shape[-1])
    out = _Int8Matmul.apply(x2, wq, scales, None)
    return _cast(out.reshape(*x.shape[:-1], wq.shape[-1]), out_dtype)


def int8_matmul_stacked(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
                        layer_idx: int, out_dtype=None) -> torch.Tensor:
    """x (..., K) @ layer ``layer_idx`` of stacked int8 wq (L, K, N) with
    scales (L, N).  Differentiable in x (K10 on the card)."""
    x2 = _rows(x) if x.is_cuda else x.reshape(-1, x.shape[-1])
    out = _Int8Matmul.apply(x2, wq, scales, layer_idx)
    return _cast(out.reshape(*x.shape[:-1], wq.shape[-1]), out_dtype)


def dual_matmul_stacked(ctx: torch.Tensor, h: torch.Tensor, w: Dict, layer_idx: int,
                        out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ctx @ W_o`` and ``h @ W_f`` of layer ``layer_idx`` in one launch,
    over the payload {"q": (L, Ko + Kf, N), "s": (L, 2, N)} that
    ``gptj.quantize_lm_params`` builds, or the int4 one
    {"q4": (L, (Ko + Kf) / 2, N), "s4": group scales} of
    ``gptj.quantize_lm_params_int4`` (K4b).  Returns (a, m), each (..., N):
    separate, because the per-branch adapters need them apart."""
    if "q4" in w:
        return _dual_int4(ctx, h, w, layer_idx, out_dtype)
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


# ===========================================================================
# int4, W4A8: K3 (int4_matmul_stacked), K4b (the q4 dual), K6 (the boundary)
# ===========================================================================


def _int4_group(k: int) -> int:
    """The group size ``quantize_int4`` takes for a K of ``k``: 256 where
    K is a multiple of 512, else two groups (small test widths)."""
    return INT4_GROUP if k % (2 * INT4_GROUP) == 0 else k // 2


def quantize_int4(w: torch.Tensor, *, compiled: bool = False) -> Dict[str, torch.Tensor]:
    """(..., K, N) weights -> {"q4": packed int8 (..., K/2, N), "s4": fp32
    (..., K/group, N)}: symmetric 4-bit, scale = max|w| / 7 per (group of
    rows, column).  Byte ``r`` of a column holds row ``r`` in its low nibble
    and row ``r + K/2`` in its high one, so a group of packed rows maps to
    two contiguous ranges of activation columns.

    ``compiled=True`` gives the bytes of the JAX function under
    ``jax.jit`` (as ``gptj.quantize_lm_params_int4`` runs it), where XLA
    turns the division by 7 into a product with fp32(1/7)."""
    w = w.float()
    K, N = w.shape[-2:]
    group = _int4_group(K)
    wg = w.reshape(*w.shape[:-2], K // group, group, N)
    amax = torch.clamp(wg.abs().amax(dim=-2, keepdim=True), min=1e-8)
    scale = amax * _INV_7 if compiled else amax / 7.0
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int32).reshape(w.shape)
    lo, hi = q[..., :K // 2, :], q[..., K // 2:, :]
    # explicit bits into uint8, then a reinterpreting view: no int32 -> int8
    # conversion of values in 128..255
    packed = (((hi & 0xF) << 4) | (lo & 0xF)).to(torch.uint8).view(torch.int8)
    return {"q4": packed.contiguous(), "s4": scale[..., 0, :].contiguous()}


def _nibbles(q4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int8 -> the signed (low, high) nibbles as int32."""
    p = q4.to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, p >> 4


def dequantize_int4(q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int4` -> fp32 (..., K, N)."""
    lo, hi = _nibbles(q4)
    q = torch.cat([lo, hi], dim=-2).float()
    K, N = q.shape[-2:]
    G = s4.shape[-2]
    return (q.reshape(*q.shape[:-2], G, K // G, N) * s4[..., :, None, :]).reshape(q.shape)


def quantize_act_block(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernels' activation quantisation of one (rows, 256) block
    (``quant.py:419-426``): int8 codes round-half-even(x / scale) with
    scale = max|x| / 127 per row (1 where the row is 0), and the (rows, 1)
    fp32 scales."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a divisor of x's shape: a scalar divisor may be taken as a product
    # with its reciprocal (PyTorch's CUDA division does), not IEEE division
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    return torch.round(xf / scale).to(torch.int8), scale


def _w4a8(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """K3's function: x (..., K) @ packed q4 (K/2, N) with (K/256, N) group
    scales, W4A8, fp32 (..., N).  Group by group, in the order of
    ``quant.py:456-457``: the two int8 dots (exact in fp32: |sum| <=
    256 * 127 * 8 < 2^24), each times its activation and weight scales,
    added to the running sum."""
    lead, k = x.shape[:-1], x.shape[-1]
    kp, n = q4.shape
    if k != 2 * kp or kp % INT4_GROUP or s4.shape[0] != k // INT4_GROUP:
        raise ValueError(f"W4A8 takes K a multiple of {2 * INT4_GROUP} with group "
                         f"{INT4_GROUP}: x {tuple(x.shape)}, q4 {tuple(q4.shape)}, "
                         f"s4 {tuple(s4.shape)}")
    x2 = x.reshape(-1, k)
    n_k, G = kp // INT4_GROUP, INT4_GROUP
    acc = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for kb in range(n_k):
        xlo, sxlo = quantize_act_block(x2[:, kb * G:(kb + 1) * G])
        xhi, sxhi = quantize_act_block(x2[:, kp + kb * G:kp + (kb + 1) * G])
        lo, hi = _nibbles(q4[kb * G:(kb + 1) * G])
        plo = xlo.float() @ lo.float()
        phi = xhi.float() @ hi.float()
        acc = acc + (plo * sxlo * s4[kb] + phi * sxhi * s4[n_k + kb])
    return acc.reshape(*lead, n)


def int4_matmul_stacked_plain(x, q4, s4, layer_idx: int) -> torch.Tensor:
    """K3's function for layer ``layer_idx`` of q4 (L, K/2, N), s4
    (L, K/256, N): fp32 (..., N)."""
    return _w4a8(x, q4[layer_idx], s4[layer_idx])


def _int4_dequant_product(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """Off the W4A8 geometry (``quant.py:764-767``): x in fp32 times the
    dequantised weights (W4A16), a plain product outside any kernel."""
    lead = x.shape[:-1]
    out = x.reshape(-1, x.shape[-1]).float() @ dequantize_int4(q4, s4)
    return out.reshape(*lead, q4.shape[-1])


def _dual_int4_parts(w: Dict, layer_idx: int, ko: int):
    """((q4, s4) of W_o, (q4, s4) of W_f) for layer ``layer_idx`` of the
    K-concatenated int4 payload."""
    q4, s4 = w["q4"][layer_idx], w["s4"][layer_idx]
    go = ko // _int4_group(ko)
    return (q4[:ko // 2], s4[:go]), (q4[ko // 2:], s4[go:])


def _dual_w4a8_ok(ko: int, kf: int, n: int) -> bool:
    """The geometry where the JAX package takes K4b (``quant.py:719-721``)."""
    return n % KERNEL_ALIGN == 0 and ko % (2 * INT4_GROUP) == 0 and kf % (2 * INT4_GROUP) == 0


def _boundary_compose(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, *, w_in,
                      fz_attn, attn_src, fz_mlp, mlp_src, u_in, o_bias, ln_eps,
                      dual, adapter, inproj):
    """The op sequence of ``_boundary_ref`` (``quant.py:1136-1170``) over
    the given dual, adapter and in_proj functions."""
    li, bf = layer_idx, torch.bfloat16
    a, m = dual(ctx, mh, w_dual, li)
    a, m = a.to(bf), m.to(bf)
    if o_bias is not None:
        a = a + o_bias[li].reshape(1, -1).to(bf)
    if fz_attn is not None:
        a = a + adapter(u_in if attn_src == "in" else a, fz_attn, li).to(bf)
    m = m + b_fc_out[li].reshape(1, -1).to(bf)
    if fz_mlp is not None:
        m = m + adapter(u_in if mlp_src == "in" else m, fz_mlp, li).to(bf)
    y = x + a + m
    y32 = y.float()
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, unbiased=False)
    u = ((y32 - mu) * torch.rsqrt(var + ln_eps) * ln_g[li].reshape(1, -1)
         + ln_b[li].reshape(1, -1)).to(bf)
    if w_in is None:
        return y, u
    return y, u, inproj(u, w_in["q4"], w_in["s4"], li + 1).to(bf)


def boundary_fused_stacked_plain(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, *,
                                 w_in=None, fz_attn=None, attn_src="out", fz_mlp=None,
                                 mlp_src="out", u_in=None, o_bias=None, ln_eps=1e-5):
    """K6's function: the composition of the plain K4b, K5 and K3."""
    return _boundary_compose(
        ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, w_in=w_in, fz_attn=fz_attn,
        attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src, u_in=u_in, o_bias=o_bias,
        ln_eps=ln_eps, dual=dual_matmul_stacked_plain, adapter=fused_adapter_stacked_plain,
        inproj=int4_matmul_stacked_plain)


def _concrete_layer(layer_idx) -> Optional[int]:
    """An integer layer index as an int: Python and numpy integers and 0-d
    integer tensors; None for anything else."""
    if isinstance(layer_idx, torch.Tensor):
        if layer_idx.dim() == 0 and not layer_idx.dtype.is_floating_point \
                and layer_idx.dtype != torch.bool:
            return int(layer_idx)
        return None
    if isinstance(layer_idx, numbers.Integral) and not isinstance(layer_idx, bool):
        return int(layer_idx)
    return None


def _boundary_geometry_ok(m_rows, D, F, w_dual, w_in, adapters, u_in) -> bool:
    """JAX's ``geometry_ok`` (``quant.py:1268-1283``) without its TPU test.
    ``adapters`` is ((payload or None, src), ...)."""
    ok = (1 <= m_rows <= BOUNDARY_MAX_ROWS and D % (2 * INT4_GROUP) == 0
          and F % (2 * INT4_GROUP) == 0
          and w_dual["q4"].shape[1] == (D + F) // 2
          and w_dual["s4"].shape[1] == (D + F) // INT4_GROUP)
    for fz, src in adapters:
        if fz is not None:
            ok = ok and fz["wd"].shape[2] % KERNEL_ALIGN == 0 and not (src == "in" and u_in is None)
    if w_in is not None:
        ok = ok and (w_in["q4"].shape[-1] % KERNEL_ALIGN == 0
                     and w_in["s4"].shape[1] == D // INT4_GROUP)
    return ok


# ---------------------------------------------------------------------------
# int4 kernel wrappers (CUDA tensors only; raise on what the kernels do not take)
# ---------------------------------------------------------------------------


@functools.cache
def _int4_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_int4_matmul
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    seg = [ptr, i64, ptr, ptr, ptr, i32]  # x, ldx, q4, s4, out, K
    fn.argtypes = [i32, i32, i32] + seg + seg + [ptr, ptr, ptr]  # codes, xs, stream
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _boundary_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_boundary
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32] * 12 + [ctypes.c_float] + [ptr] * 28 + [ctypes.c_longlong, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check_int4(name: str, q4: torch.Tensor, s4: torch.Tensor, k: int, device) -> int:
    """Packed int8 (K/2, N) and fp32 (K/256, N), both contiguous, K a
    multiple of 512 and N of 128.  Returns N."""
    _check_cuda(name, q4, torch.int8, device)
    _check_cuda(f"{name} scales", s4, torch.float32, device)
    if k % (2 * INT4_GROUP):
        raise ValueError(f"{name}: K must be a multiple of {2 * INT4_GROUP} (group "
                         f"{INT4_GROUP}), got {k}")
    if q4.dim() != 2 or q4.shape[0] != k // 2 or q4.shape[1] % KERNEL_ALIGN:
        raise ValueError(f"{name} must be ({k // 2}, N) with N a multiple of "
                         f"{KERNEL_ALIGN}, got {tuple(q4.shape)}")
    n = q4.shape[1]
    if tuple(s4.shape) != (k // INT4_GROUP, n):
        raise ValueError(f"{name} scales must be ({k // INT4_GROUP}, {n}), got {tuple(s4.shape)}")
    if not (q4.is_contiguous() and s4.is_contiguous()) or q4.data_ptr() % 16:
        raise ValueError(f"{name} and its scales must be contiguous, with a 16-byte aligned base")
    return n


def _launch_int4(segments, m: int, n: int, device) -> None:
    """One launch of ``csrc/int4_matmul.cu`` over one or two segments of
    (x (M, K) bf16, q4 (K/2, N) int8, s4 (K/256, N) fp32, out (M, N) fp32).
    Above 8 rows the kernel quantises x once into scratch: int8 codes of
    every segment's rows, and fp32 scales of its rows rounded up to a
    multiple of 192 (``XS_ROWS`` in the source: the wgmma tile reads whole
    row tiles of 64 or 96 scales)."""
    args = []
    for x, q4, s4, out in segments:
        args += [x.data_ptr(), x.stride(0), q4.data_ptr(), s4.data_ptr(), out.data_ptr(),
                 x.shape[1]]
    if len(segments) == 1:
        args += [None, 0, None, None, None, 0]
    codes = xs = None
    if m > 8:
        k = sum(seg[0].shape[1] for seg in segments)
        codes = torch.empty(m * k, dtype=torch.int8, device=device)
        xs_rows = -(-m // 192) * 192
        xs = torch.empty(xs_rows * k // INT4_GROUP, dtype=torch.float32, device=device)
    err = _int4_fn()(len(segments), m, n, *args, None if codes is None else codes.data_ptr(),
                     None if xs is None else xs.data_ptr(),
                     torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4 matmul kernel launch failed: cudaError {err}")


def int4_matmul_stacked_kernel(x2: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
                               layer_idx: int) -> torch.Tensor:
    """K3: x2 (M, K) bf16 @ layer ``layer_idx`` of q4 (L, K/2, N) with s4
    (L, K/256, N), W4A8 -> fp32 (M, N), on the card.  Each launch adds one
    to ``int4_matmul_stacked_kernel.launches``."""
    _check_cuda("x", x2, torch.bfloat16, None)
    _check_rows("x", x2)
    if q4.dim() != 3 or s4.dim() != 3:
        raise ValueError(f"stacked int4 weights must be (L, K/2, N) with (L, K/256, N) "
                         f"scales, got {tuple(q4.shape)}, {tuple(s4.shape)}")
    ql, sl = q4[layer_idx], s4[layer_idx]
    n = _check_int4("w", ql, sl, x2.shape[1], x2.device)
    out = torch.empty((x2.shape[0], n), dtype=torch.float32, device=x2.device)
    _launch_int4([(x2, ql, sl, out)], x2.shape[0], n, x2.device)
    int4_matmul_stacked_kernel.launches += 1
    return out


def int4_dual_kernel(c2: torch.Tensor, h2: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
                     layer_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4b: (c2 @ W_o, h2 @ W_f) W4A8 for layer ``layer_idx`` of the
    K-concatenated int4 payload q4 (L, (Ko + Kf)/2, N), s4
    (L, (Ko + Kf)/256, N), in one launch.  Counts in
    ``int4_dual_kernel.launches``."""
    for name, t in (("ctx", c2), ("h", h2)):
        _check_cuda(name, t, torch.bfloat16, c2.device)
        _check_rows(name, t)
    if c2.shape[0] != h2.shape[0]:
        raise ValueError(f"ctx and h differ in rows: {c2.shape[0]} vs {h2.shape[0]}")
    if q4.dim() != 3 or s4.dim() != 3:
        raise ValueError(f"dual int4 payload must be q4 (L, (Ko+Kf)/2, N), s4 "
                         f"(L, (Ko+Kf)/256, N), got {tuple(q4.shape)}, {tuple(s4.shape)}")
    ko, kf = c2.shape[1], h2.shape[1]
    if q4.shape[1] != (ko + kf) // 2:
        raise ValueError(f"payload has {q4.shape[1]} packed rows, ctx + h give {(ko + kf) // 2}")
    (qo, so), (qf, sf) = _dual_int4_parts({"q4": q4, "s4": s4}, layer_idx, ko)
    n = _check_int4("w_o", qo, so, ko, c2.device)
    _check_int4("w_f", qf, sf, kf, c2.device)
    m = c2.shape[0]
    a = torch.empty((m, n), dtype=torch.float32, device=c2.device)
    mo = torch.empty((m, n), dtype=torch.float32, device=c2.device)
    _launch_int4([(c2, qo, so, a), (h2, qf, sf, mo)], m, n, c2.device)
    int4_dual_kernel.launches += 1
    return a, mo


BOUNDARY_PHASES = ("dual", "dual sums", "adapter down", "down sums", "adapter up", "LN",
                   "in_proj", "in_proj sums")  # the stamped build's phases, in order


def boundary_plan(*, m: int, d: int, f: int, ni: int, dh=(0, 0)) -> Dict:
    """The work partition of ``csrc/boundary.cu`` (its ``make_plan`` and
    ``layout``) for m rows, ``ni`` = 0 on the last layer, ``dh`` the
    attention and mlp adapters' hidden widths (0: absent): each phase's
    items, the arrival counters (the grid barrier's, then one a column tile
    of the dual, of each adapter's down product and of the in_proj) and the
    scratch's byte offsets.  The terms region holds the largest phase's
    chunk terms: a phase writes it only after the grid barrier that follows
    the sums of the phase before.  The up product has no terms: an item is a
    32-column slice over all of dh (both adapters), ``slice_stages`` ring
    tiles of 1024 rows an adapter."""
    T, no, nf, C = d // 128, d // 512, f // 512, -(-d // 256)
    tdn = [k // 128 for k in dh]
    gi, ti = d // 512, ni // 128
    counters = {"dual": 1, "down": 1 + T, "in": 1 + T + sum(tdn)}
    n_counters = counters["in"] + ti
    items = {"dual": (no + nf) * T, "adapter_down": C * sum(tdn),
             "adapter_up": d // 32 if any(dh) else 0, "in_proj": gi * ti}
    terms = max((no + nf) * m * d, C * m * sum(dh), gi * m * ni)
    act = _round256(2 * m * d) if any(dh) else 0
    off = {"terms": _round256(8 + 4 * n_counters)}
    off["ab"] = off["terms"] + _round256(4 * terms)
    off["mb"] = off["ab"] + act
    off["h_attn"] = off["mb"] + act
    off["h_mlp"] = off["h_attn"] + _round256(2 * m * dh[0])
    off["bytes"] = off["h_mlp"] + _round256(2 * m * dh[1])
    return dict(T=T, no=no, nf=nf, C=C, tdn=tdn, dh=list(dh), gi=gi, ti=ti, counters=counters,
                n_counters=n_counters, items=items, terms=terms, offsets=off)


@functools.lru_cache(maxsize=64)
def _boundary_bytes(m: int, d: int, f: int, ni: int, dh_a: int, dh_m: int) -> int:
    """``boundary_plan``'s scratch bytes (a function of the shapes alone)."""
    return boundary_plan(m=m, d=d, f=f, ni=ni, dh=(dh_a, dh_m))["offsets"]["bytes"]


def slice_stages(k: int) -> int:
    """The ring tiles of one up slice over k rows (1024 rows a tile)."""
    return -(-k // 1024)


def boundary_schedule(plan: Dict, grid: int) -> Dict:
    """Each block's ring tiles, as the kernel's producer walks them and its
    consumers take them: ``{block: [(phase, item, tile), ...]}``, items in
    contiguous ranges (block b: [b n / grid, (b + 1) n / grid)) and
    ``tile`` the weight tile read: ("dual", group, column tile), ("wd",
    adapter, K chunk, column tile), ("wu", adapter, 1024-row stage, 32-column
    slice), ("in", group, column tile); an up item reads one tile a stage of
    each adapter."""
    out = {b: [] for b in range(grid)}

    def walk(phase, n, tiles_of):
        for b in range(grid):
            for i in range(b * n // grid, (b + 1) * n // grid):
                out[b] += [(phase, i, tile) for tile in tiles_of(i)]

    T, ti, tdn = plan["T"], plan["ti"], plan["tdn"]
    walk("dual", plan["items"]["dual"], lambda i: [("dual", i // T, i % T)])
    n0 = plan["C"] * tdn[0]

    def down(i):
        a, j = (0, i) if i < n0 else (1, i - n0)
        return [("wd", a, j // tdn[a], j % tdn[a])]

    walk("adapter_down", plan["items"]["adapter_down"], down)
    walk("adapter_up", plan["items"]["adapter_up"],
         lambda sl: [("wu", a, st, sl) for a, k in enumerate(plan["dh"])
                     for st in range(slice_stages(k))])
    walk("in_proj", plan["items"]["in_proj"], lambda i: [("in", i // ti, i % ti)])
    return out


def phase_breakdown(stamps: torch.Tensor, phases=BOUNDARY_PHASES) -> Dict[str, float]:
    """A stamped build's %globaltimer stamps (grid, phases, 2) -> ms per
    phase (the slowest block's end minus the first block's start, over the
    blocks that ran it) and the wait after it (the next phase's first start
    minus this phase's last end: a grid barrier, or the arrivals and the
    counters before owned sums), then the launch's total.  ``phases``: the
    build's phase names (``BOUNDARY_PHASES``, ``ADAPTER_PHASES``)."""
    st = stamps.detach().to("cpu", torch.float64)
    out, prev = {}, None
    ran = [i for i in range(st.shape[1]) if bool((st[:, i, 1] > 0).any())]
    for i in ran:
        used = st[:, i, 1] > 0
        start, end = st[used, i, 0].min().item(), st[used, i, 1].max().item()
        if prev is not None:
            out[f"{phases[prev[0]]} wait"] = (start - prev[1]) / 1e6
        out[phases[i]] = (end - start) / 1e6
        prev = (i, end)
    first = st[st[:, ran[0], 1] > 0, ran[0], 0].min().item()
    out["total"] = (prev[1] - first) / 1e6
    return out


def _row_ptr(name: str, t: torch.Tensor, li: int, n: int, device) -> int:
    """The address of row ``li`` of a contiguous fp32 (L, n) (or (L, 1, n))
    stack on CUDA device index ``device``, without making a view."""
    if t.get_device() != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be an fp32 CUDA tensor on cuda:{device}, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() < 2 or t.shape[0] <= li or t.numel() != t.shape[0] * n or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (L > {li}, {n}) stack, got "
                         f"{tuple(t.shape)}")
    return t.data_ptr() + li * n * 4


def _boundary_launch(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, *, w_in, fz_attn,
                     attn_src, fz_mlp, mlp_src, u_in, o_bias, ln_eps, stamps=None):
    """One launch of ``csrc/boundary.cu``: checks, the layer's pointers into
    the stacks, one scratch allocation.  Returns bf16 (y, u) or (y, u,
    fused)."""
    dev = ctx.get_device()
    rows = [("ctx", ctx), ("mh", mh), ("x", x)] + ([("u_in", u_in)] if u_in is not None else [])
    for name, t in rows:
        if t.get_device() != dev or dev < 0 or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be a bf16 CUDA tensor on {ctx.device}, got "
                             f"{t.dtype} on {t.device}")
        _check_rows(name, t)
        if t.stride(0) != t.shape[1]:
            raise ValueError(f"{name} must be contiguous")
    m, D = ctx.shape
    F = mh.shape[1]
    if mh.shape[0] != m or tuple(x.shape) != (m, D) or (
            u_in is not None and tuple(u_in.shape) != (m, D)):
        raise ValueError(f"rows disagree: ctx {tuple(ctx.shape)}, mh {tuple(mh.shape)}, "
                         f"x {tuple(x.shape)}")
    for src in (attn_src, mlp_src):
        if src not in ("out", "in"):
            raise ValueError(f"adapter src must be 'out' or 'in', got {src!r}")
    if not (1 <= m <= BOUNDARY_MAX_ROWS and D % (2 * INT4_GROUP) == 0
            and F % (2 * INT4_GROUP) == 0):
        raise ValueError(f"the boundary kernel takes 1..{BOUNDARY_MAX_ROWS} rows, D and F "
                         f"multiples of {2 * INT4_GROUP}; got m={m}, D={D}, F={F}")
    q4, s4 = w_dual["q4"], w_dual["s4"]
    Ld = q4.shape[0]
    _check_stack("w_dual", q4, torch.int8, (Ld, (D + F) // 2, D), dev)
    _check_stack("w_dual scales", s4, torch.float32, (Ld, (D + F) // INT4_GROUP, D), dev)
    li = _layer_index(layer_idx, Ld)
    ni, li_n, qi, si = 0, 0, None, None
    if w_in is not None:
        qi, si = w_in["q4"], w_in["s4"]
        li_n = qi.shape[0]
        ni = qi.shape[-1]
        if ni % KERNEL_ALIGN:
            raise ValueError(f"w_in must be N wide with N a multiple of {KERNEL_ALIGN}, got {ni}")
        _check_stack("w_in", qi, torch.int8, (li_n, D // 2, ni), dev)
        _check_stack("w_in scales", si, torch.float32, (li_n, D // INT4_GROUP, ni), dev)
        if li + 1 >= li_n:
            raise ValueError(f"layer_idx={layer_idx} with w_in reads layer {li} + 1 of a "
                             f"{li_n}-layer stack")
    vecs = [_row_ptr(n, t, li, D, dev) for n, t in
            (("b_fc_out", b_fc_out), ("ln_g", ln_g), ("ln_b", ln_b))]
    ob = None if o_bias is None else _row_ptr("o_bias", o_bias, li, D, dev)
    dims, ptrs, src = [], [], 0
    for k, (name, fz, s_) in enumerate((("attn adapter", fz_attn, attn_src),
                                        ("mlp adapter", fz_mlp, mlp_src))):
        if fz is None:
            dims.append((0, 0))
            ptrs += [None] * 6
            continue
        La, dh = _adapter_stacks(name, fz, D, dev)
        if li >= La:
            raise ValueError(f"{name}: layer {li} of a {La}-layer stack")
        if s_ == "in":
            if u_in is None:
                raise ValueError(f"{name} reads u_in: pass u_in")
            src |= 1 << k
        dims.append((dh, La))
        ptrs += _adapter_ptrs(fz, li, D, dh)
    (dh_a, l_a), (dh_m, l_m) = dims
    plan_bytes = _boundary_bytes(m, D, F, ni, dh_a, dh_m)
    device = ctx.device
    scratch = torch.empty(plan_bytes, dtype=torch.uint8, device=device)
    y = torch.empty((m, D), dtype=torch.bfloat16, device=device)
    u = torch.empty((m, D), dtype=torch.bfloat16, device=device)
    fused = None if w_in is None else torch.empty((m, ni), dtype=torch.bfloat16, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _boundary_fn()(
        m, D, F, ni, dh_a, dh_m, src, li, Ld, li_n, l_a, l_m, ln_eps,
        ptr(ctx), ptr(mh), ptr(x), ptr(u_in), ptr(q4), ptr(s4), *vecs, ob, *ptrs,
        ptr(qi), ptr(si), ptr(y), ptr(u), ptr(fused), ptr(scratch), plan_bytes, ptr(stamps),
        _stream(dev))
    if err != 0:
        raise RuntimeError(f"boundary kernel launch failed: cudaError {err}")
    return (y, u) if fused is None else (y, u, fused)


def boundary_kernel(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, *, w_in=None,
                    fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out", u_in=None,
                    o_bias=None, ln_eps=1e-5):
    """K6: ``boundary_fused_stacked`` for 1..8 bf16 rows in one cooperative
    launch of ``csrc/boundary.cu``.  Returns bf16 (y, u) or (y, u, fused).
    Counts in ``boundary_kernel.launches``."""
    out = _boundary_launch(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, w_in=w_in,
                           fz_attn=fz_attn, attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src,
                           u_in=u_in, o_bias=o_bias, ln_eps=ln_eps)
    boundary_kernel.launches += 1
    return out


def boundary_stamped(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, **kw):
    """K6's stamped build, for measurement only (never on the main path and
    not counted in ``boundary_kernel.launches``): ``boundary_kernel``'s
    outputs, then int64 stamps (grid, len(BOUNDARY_PHASES), 2) of each
    block's %globaltimer at each phase's start and end (0 where a block or
    a phase did not run); ``phase_breakdown`` reads them."""
    kw = dict(dict(w_in=None, fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out",
                   u_in=None, o_bias=None, ln_eps=1e-5), **kw)
    stamps = torch.zeros((_grid_of("magma_boundary_grid"), len(BOUNDARY_PHASES), 2),
                         dtype=torch.int64, device=ctx.device)
    return (*_boundary_launch(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, **kw,
                              stamps=stamps), stamps)


for _fn in (int4_matmul_stacked_kernel, int4_dual_kernel, boundary_kernel):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# int4 public entries
# ---------------------------------------------------------------------------


def int4_matmul_stacked(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor, layer_idx: int,
                        out_dtype=None) -> torch.Tensor:
    """x (..., K) @ layer ``layer_idx`` of stacked int4 q4 (L, K/2, N) with
    group scales s4 (L, K/group, N).  Group 256: K3 on CUDA, its W4A8
    plain version on the CPU; another group: the dequantising fp32
    product on either device, as in the JAX package."""
    lead, n = x.shape[:-1], q4.shape[-1]
    if 2 * q4.shape[-2] // s4.shape[-2] != INT4_GROUP:
        out = _int4_dequant_product(x, q4[layer_idx], s4[layer_idx])
    elif not x.is_cuda:
        out = int4_matmul_stacked_plain(x, q4, s4, layer_idx)
    else:
        out = int4_matmul_stacked_kernel(_rows(x), q4, s4, layer_idx)
    return _cast(out.reshape(*lead, n), out_dtype)


def _dual_int4(ctx, h, w: Dict, layer_idx: int, out_dtype):
    """The q4 branch of ``dual_matmul_stacked``: K4b on its geometry (the
    plain W4A8 version on the CPU), else the dequantising fp32 products."""
    lead, n = ctx.shape[:-1], w["q4"].shape[-1]
    ko, kf = ctx.shape[-1], h.shape[-1]
    if not _dual_w4a8_ok(ko, kf, n):
        (qo, so), (qf, sf) = _dual_int4_parts(w, layer_idx, ko)
        a, m = _int4_dequant_product(ctx, qo, so), _int4_dequant_product(h, qf, sf)
    elif not ctx.is_cuda:
        a, m = dual_matmul_stacked_plain(ctx, h, w, layer_idx)
    else:
        a, m = int4_dual_kernel(_rows(ctx), _rows(h), w["q4"], w["s4"], layer_idx)
    return _cast(a.reshape(*lead, n), out_dtype), _cast(m.reshape(*lead, n), out_dtype)


def boundary_fused_stacked(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, *,
                           w_in=None, fz_attn=None, attn_src="out", fz_mlp=None,
                           mlp_src="out", u_in=None, o_bias=None, ln_eps=1e-5):
    """Everything between two decode attentions, as the JAX package's
    function of this name (``quant.py:1217``)::

        a  = ctx @ W_o [+ o_bias] [+ adapter_attn]
        m  = mh @ W_fc_out + b_fc_out [+ adapter_mlp]
        y  = x + a + m
        u  = LN(y; ln_g/ln_b[layer_idx])     (the next layer's ln_1, or ln_f)
        fused = u @ W_in[layer_idx + 1]      (when ``w_in`` is given)

    for 2-D rows; weights are the stacked int4 payloads of
    ``gptj.quantize_lm_params_int4`` and fused int8 adapters; ``u_in`` is
    this layer's own LN output (the input of parallel adapters).  Returns
    bf16 (y, u) or (y, u, fused).  On its geometry (m <= 8, group 256) a
    CUDA call is one K6 launch; otherwise, and on the CPU, the composition
    of the public dual, adapter and in_proj products."""
    if w_in is not None:
        li = _concrete_layer(layer_idx)
        L = w_in["q4"].shape[0]
        # the in_proj phase reads layer layer_idx + 1: refuse the last layer
        if li is not None and li >= L - 1:
            raise ValueError(
                f"boundary_fused_stacked: layer_idx={li} with w_in set would read layer "
                f"{li + 1} of an {L}-layer stack; pass w_in=None on the last layer")
    m_rows, D = ctx.shape
    adapters = ((fz_attn, attn_src), (fz_mlp, mlp_src))
    kw = dict(w_in=w_in, fz_attn=fz_attn, attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src,
              u_in=u_in, o_bias=o_bias, ln_eps=ln_eps)
    if ctx.is_cuda and _boundary_geometry_ok(m_rows, D, mh.shape[1], w_dual, w_in,
                                             adapters, u_in):
        bf = torch.bfloat16
        return boundary_kernel(
            ctx.to(bf).contiguous(), mh.to(bf).contiguous(), x.to(bf).contiguous(), w_dual,
            b_fc_out, ln_g, ln_b, layer_idx,
            **dict(kw, u_in=None if u_in is None else u_in.to(bf).contiguous()))
    return _boundary_compose(ctx, mh, x, w_dual, b_fc_out, ln_g, ln_b, layer_idx, **kw,
                             dual=dual_matmul_stacked, adapter=fused_adapter_stacked,
                             inproj=int4_matmul_stacked)
