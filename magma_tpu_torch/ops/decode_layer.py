"""Whole decode layers of a b=1 step: K7 (one layer) and K8 (all layers).

Port of ``magma_tpu/ops/decode_layer.py``.  A layer of the single-stream
decode step, from its in_proj output ``fused = [q | k | v | m_pre]``::

    q, k  = rotary(q, k) in fp32; q *= scale
    ctx   = attention of q over the cache positions < pos and the token
            itself (bf16 or int8 cache), rounded to bf16 once
    mh    = bf16(gelu_tanh(m_pre + b_fc_in))
    y, u  = dual (o_proj + fc_out), adapters, residual, the next LN
    fused = the next layer's in_proj of u (unless the last layer)

with the int4 (``gptj.quantize_lm_params_int4``) or the int8
(``gptj.quantize_lm_params``) serving stacks.  ``decode_layer_fused`` (K7)
runs one layer, ``decode_all_layers_fused`` (K8) all of them and returns
the step's hidden state and every layer's new K/V rows.  Both kernels are
``csrc/decode_layer.cu``: one cooperative launch whose producer warps stream
every weight tile through TMA ahead of the phase that consumes it, with K6's
arithmetic (``stream_plan`` and ``stream_schedule`` mirror its work
partition).

Each public entry launches its kernel on CUDA tensors where
``declayer_supported`` holds and raises on a CUDA input it does not take;
on CPU tensors it runs its plain version, ``decode_layer_plain`` or
``decode_all_layers_plain``: the JAX package's oracles ``_declayer_ref``
and ``_all_layers_ref`` op for op, which are not the boundary path's
arithmetic (fp32 rotary, fp32 softmax with the token itself, weights not
rounded to bf16).  Their products are the port's plain versions, picked by
geometry as the public products pick them, so no kernel launches inside a
plain version on either device.

The cache scales stay in the cache's (L, b, h, max_len) layout: the JAX
package's position-major copy, its rotary matrix and its TPU block and
grid tuning are not ported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from magma_tpu_torch import observability as obs
from magma_tpu_torch.ops.quant import (INT4_GROUP, KERNEL_ALIGN, _boundary_compose,
                                       _check_cuda, _concrete_layer, _dual_int4_parts,
                                       _dual_w4a8_ok, _int4_dequant_product,
                                       dual_matmul_stacked_plain, fused_adapter_stacked_plain,
                                       int4_matmul_stacked_plain, int8_matmul_stacked_plain)
from magma_tpu_torch.ops.rotary import apply_rotary

# the JAX package's masking constant (decode_layer.py:65)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 256     # the kernels' head_dim: one thread a dimension
ATT_CHUNK = 16     # cache positions of one attention item (csrc/decode_layer.cu)
MAX_LEN_ALIGN = 64  # the gate's max_len multiple, as JAX's _pick_sblk asks
# csrc/decode_layer.cu: a weight tile is TILE_ROWS rows (int4: packed rows,
# one W4A8 group) x TILE_COLS columns; a phase's activations fit XBUF_BYTES
# of shared memory (int4 codes with XSCALES block scales, or bf16 rows)
TILE_ROWS, TILE_COLS = 256, 128
XBUF_BYTES, XSCALES = 40960, 256
# the launch's phases (each closed by a grid barrier), as the stamped build
# times them
PHASES = ("attention", "dual", "adapter_down", "adapter_up+residual", "ln+in_proj")


def _weight_format(w) -> Optional[str]:
    if not isinstance(w, dict):
        return None
    if "q4" in w:
        return "int4"
    if "q" in w:
        return "int8"
    return None


def _adapter_bk(D: int, DH: int) -> Optional[int]:
    """The adapter's row block of the JAX kernels (``decode_layer.py:450``);
    the CUDA kernel takes the adapters where one exists."""
    return next((b for b in (512, 384, 256, 128) if D % b == 0 and DH % b == 0), None)


def _stream_fits(D: int, F_: int, wf: str) -> bool:
    """Whether a phase's activations fit the kernel's shared memory: the
    dual's codes (int4) or bf16 rows (int8) of ctx and mh, and the LN's y,
    u and u's codes (``magma_decode_layers``'s ``fits``)."""
    dual = D + F_ if wf == "int4" else 2 * (D + F_)
    return dual <= XBUF_BYTES and (D + F_) // 256 <= XSCALES and 5 * D <= XBUF_BYTES


def _layer_geometry_ok(n_heads, head_dim, d_ff, max_len, w_out_proj) -> bool:
    """The gate's conditions on the layer itself and its dual payload."""
    wf = _weight_format(w_out_proj)
    if wf is None or head_dim != HEAD_DIM or n_heads % 8:
        return False
    D = n_heads * head_dim
    if (D % INT4_GROUP or d_ff % INT4_GROUP or max_len % MAX_LEN_ALIGN
            or not _stream_fits(D, d_ff, wf)):
        return False
    if wf == "int4":
        return (D % (2 * INT4_GROUP) == 0 and d_ff % (2 * INT4_GROUP) == 0
                and w_out_proj["q4"].shape[1] == (D + d_ff) // 2
                and w_out_proj["s4"].shape[1] == (D + d_ff) // INT4_GROUP)
    return w_out_proj["q"].shape[1] == D + d_ff and w_out_proj["s"].shape[1] == 2


def _inproj_ok(D: int, w_in_proj) -> bool:
    if "q4" in w_in_proj:
        return (w_in_proj["s4"].shape[1] == D // INT4_GROUP
                and w_in_proj["q4"].shape[-1] % KERNEL_ALIGN == 0)
    return w_in_proj["q"].shape[-1] % KERNEL_ALIGN == 0


def declayer_supported(*, b, s, n_heads, head_dim, d_ff, max_len, w_in_proj, w_out_proj,
                       has_bvecs) -> bool:
    """The JAX package's geometry gate (``decode_layer.py:485-521``) without
    its backend test: b = s = 1, matching int4 or int8 in_proj and out_proj
    payloads, head_dim 256, n_heads a multiple of 8, D and F multiples of
    256 (512 for int4), max_len a multiple of 64, N of the in_proj a
    multiple of 128; and the port's own bound, that a phase's activations
    fit the kernel's shared memory (``_stream_fits``: GPT-J 6B's D 4096 and
    F 16384 do in both formats)."""
    wf = _weight_format(w_out_proj)
    return (wf is not None and _weight_format(w_in_proj) == wf and b == 1 and s == 1
            and bool(has_bvecs) and _layer_geometry_ok(n_heads, head_dim, d_ff, max_len, w_out_proj)
            and _inproj_ok(n_heads * head_dim, w_in_proj))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _dual_plain(ctx, mh, w: Dict, li: int):
    """The dual product as ``dual_matmul_stacked`` picks it on the CPU:
    W4A8 or W8A16 on the kernels' geometry, the dequantising fp32 product
    off it."""
    if "q4" in w and not _dual_w4a8_ok(ctx.shape[-1], mh.shape[-1], w["q4"].shape[-1]):
        (qo, so), (qf, sf) = _dual_int4_parts(w, li, ctx.shape[-1])
        return _int4_dequant_product(ctx, qo, so), _int4_dequant_product(mh, qf, sf)
    return dual_matmul_stacked_plain(ctx, mh, w, li)


def _inproj_plain(u, w_in: Dict, li: int) -> torch.Tensor:
    """Layer ``li`` of the in_proj as ``int4_matmul_stacked`` or
    ``int8_matmul_stacked`` pick it on the CPU."""
    if "q4" in w_in:
        q4, s4 = w_in["q4"], w_in["s4"]
        if 2 * q4.shape[-2] // s4.shape[-2] != INT4_GROUP:
            return _int4_dequant_product(u, q4[li], s4[li])
        return int4_matmul_stacked_plain(u, q4, s4, li)
    return int8_matmul_stacked_plain(u, w_in["q"], w_in["s"], li)


def decode_layer_plain(fused_in, x, sincos, k_cache, v_cache, kv_scales, cache_pos, w_dual,
                       b_fc_in, b_fc_out, ln_g, ln_b, layer_idx, *, n_heads, w_in=None,
                       fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out", u_in=None,
                       o_bias=None, scale, ln_eps=1e-5):
    """K7's function, ``_declayer_ref`` (``decode_layer.py:376-437``) op for
    op: see ``decode_layer_fused`` for the arguments."""
    h = n_heads
    F_ = b_fc_in.shape[-1]
    D = (fused_in.shape[1] - F_) // 3
    hd = D // h
    li = layer_idx
    bf = torch.bfloat16
    sin, cos = sincos
    rd = 2 * sin.shape[-1]
    q, k, v = (fused_in[0:1, i * D:(i + 1) * D].reshape(1, 1, h, hd).float() for i in range(3))
    # the rotation of the JAX oracle's fp32 R matmul, elementwise
    q_rot = apply_rotary(q, sin.float(), cos.float(), rd)[0, 0] * scale
    k_rot = apply_rotary(k, sin.float(), cos.float(), rd)[0, 0]
    kc, vc = k_cache[li][0].float(), v_cache[li][0].float()
    max_len = kc.shape[0]
    scores = torch.einsum("khd,hd->kh", kc, q_rot)
    if kv_scales is not None:
        kst, vst = (sc[li][0].transpose(0, 1).float() for sc in kv_scales)  # (max_len, h)
        scores = scores * kst
    pos = torch.as_tensor(cache_pos, device=scores.device).reshape(())
    valid = torch.arange(max_len, device=scores.device)[:, None] < pos
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    s_self = (q_rot * k_rot).sum(1)
    m = torch.maximum(scores.amax(0), s_self)
    p = torch.exp(scores - m[None, :])
    p_self = torch.exp(s_self - m)
    l = p.sum(0) + p_self
    if kv_scales is not None:
        p = p * vst
    v2 = v[0, 0]
    ctx = (torch.einsum("kh,khd->hd", p, vc) + p_self[:, None] * v2) / l[:, None]
    ctx_row = ctx.reshape(1, D).to(bf)
    mh = F.gelu(fused_in[0:1, 3 * D:].float() + b_fc_in[li].reshape(1, F_).float(),
                approximate="tanh").to(bf)
    y, u = _boundary_compose(
        ctx_row, mh, x, w_dual, b_fc_out, ln_g, ln_b, li, w_in=None, fz_attn=fz_attn,
        attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src, u_in=u_in, o_bias=o_bias,
        ln_eps=ln_eps, dual=_dual_plain, adapter=fused_adapter_stacked_plain, inproj=None)
    k_new = k_rot.reshape(1, D).to(bf)
    v_new = v2.reshape(1, D).to(bf)
    if w_in is None:
        return y, u, k_new, v_new
    # the next layer's in_proj in either format (_boundary_compose's is int4)
    return y, u, _inproj_plain(u, w_in, li + 1).to(bf), k_new, v_new


def decode_all_layers_plain(fused0, x0, u0, sincos, k_cache, v_cache, kv_scales, cache_pos,
                            w_dual, w_in, b_fc_in, b_fc_out, ln_g, ln_b, *, n_heads,
                            fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out",
                            o_bias=None, scale, ln_eps=1e-5):
    """K8's function, ``_all_layers_ref`` (``decode_layer.py:1271-1293``):
    ``decode_layer_plain`` layer by layer, each fed its own LN output as
    ``u_in``.  Returns (y (1, D), k_new (L, 1, D), v_new (L, 1, D))."""
    L = k_cache.shape[0]
    fused, x2, u2 = fused0, x0, u0
    k_news, v_news = [], []
    for l in range(L):
        outs = decode_layer_plain(
            fused, x2, sincos, k_cache, v_cache, kv_scales, cache_pos, w_dual, b_fc_in,
            b_fc_out, ln_g, ln_b, l, n_heads=n_heads, w_in=None if l == L - 1 else w_in,
            fz_attn=fz_attn, attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src, u_in=u2,
            o_bias=o_bias, scale=scale, ln_eps=ln_eps)
        if l == L - 1:
            x2, u2, kn, vn = outs
        else:
            x2, u2, fused, kn, vn = outs
        k_news.append(kn)
        v_news.append(vn)
    return x2, torch.stack(k_news), torch.stack(v_news)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only; raise on what the kernel does not take)
# ---------------------------------------------------------------------------

# the C entry's arrays (csrc/decode_layer.cu, enums Ints and Ptrs), in order
_INTS = ("layers", "l0", "l1", "in_until", "heads", "d", "f", "ni", "max_len", "rotary", "int4",
         "kv8", "dh_a", "src_a", "dh_m", "src_m", "head_dim", "chunk", "n_counters", "n_terms")
_FLOATS = ("scale", "eps")
_ADAPTER = ("wd", "sd", "bd", "wu", "su", "bu", "h")
_PTRS = ("pos", "sin", "cos", "fused_in", "x_in", "u_in", "k_cache", "v_cache", "k_scale",
         "v_scale", "qd", "sd", "b_fc_in", "b_fc_out", "ln_g", "ln_b", "o_bias",
         *(f"a_{k}" for k in _ADAPTER), *(f"m_{k}" for k in _ADAPTER), "qi", "si", "y", "y2", "u",
         "fused", "k_new", "v_new", "part", "terms", "ctx", "mh", "ab", "mb", "codes", "xsc",
         "counters", "stamps")


@functools.cache
def _decode_fn():
    from magma_tpu_torch.cuda_build import load_library

    fn = load_library().magma_decode_layers
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i32, ptr, i32, ptr, i32, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def decode_layers_grid() -> int:
    """Blocks of a K7/K8 launch on the current device (one per SM)."""
    from magma_tpu_torch.cuda_build import load_library

    blocks = ctypes.c_int(0)
    err = load_library().magma_decode_layers_grid(ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"the decode-layer kernel cannot be launched here: cudaError {err}, "
                           f"{blocks.value} co-resident blocks")
    return blocks.value


def stream_plan(*, d: int, f: int, ni: int, h: int, wf: str, dh=(0, 0)) -> Dict:
    """The work partition of ``csrc/decode_layer.cu`` (its ``make_plan``):
    each product's K chunks and 128-column tiles, and the scratch the launch
    needs: arrival counters (one a column tile for the dual or the in_proj,
    then one a head for the attention) and chunk terms (fp32) in two
    regions, ``terms_a`` for the dual's and adapter up's, then adapter
    down's and the in_proj's, so no phase writes a region the grid may
    still be reading.  ``dh``: the attention and mlp adapters' hidden
    widths (0: absent)."""
    rows = 2 * TILE_ROWS if wf == "int4" else TILE_ROWS  # activation values a K chunk
    cup = [-(-k // TILE_ROWS) for k in dh]
    cdn = d // TILE_ROWS
    terms_a = max((d + f) // rows * d, 2 * max(cup) * d)
    terms_b = max(2 * cdn * max(dh), d // rows * ni)
    return dict(
        cho=d // rows, chf=f // rows, td=d // TILE_COLS, cdn=cdn,
        tdn=[k // TILE_COLS for k in dh], cup=cup, cin=d // rows, ti=ni // TILE_COLS,
        counters=max(d, ni) // TILE_COLS + h, terms_a=terms_a,
        terms=terms_a + terms_b)


def stream_schedule(plan: Dict, *, h: int, pos: int, grid: int, l0: int, l1: int,
                    in_until: int):
    """The launch's items in the order each block takes them, as the
    kernel's producer walks them: ``{block: [(layer, kind, item, tile), ...]}``
    with ``tile`` the ring tile the item reads (None for an attention item
    at pos 0, which folds its head without a cache chunk).  The kinds, one
    a phase, in order: attention, dual, adapter_down, adapter_up, in_proj.
    Items i = b, b + grid, ... of each kind, rotated by the items of the
    kinds before."""
    nck = -(-pos // ATT_CHUNK)
    nci = max(nck, 1)
    out = {b: [] for b in range(grid)}
    off = 0

    def walk(layer, phase, n, tile_of):
        nonlocal off
        for b in range(grid):
            for i in range((b - off) % grid, n, grid):
                out[b].append((layer, phase, i, tile_of(i)))
        off = (off + n) % grid

    adapters = any(plan["tdn"])
    for layer in range(l0, l1):
        walk(layer, "attention", h * nci,
             lambda i: ("cache", i // nci, i % nci) if nck else None)
        walk(layer, "dual", (plan["cho"] + plan["chf"]) * plan["td"],
             lambda i: ("dual", i // plan["td"], i % plan["td"]))
        if adapters:
            n0 = plan["cdn"] * plan["tdn"][0]

            def down(i):
                a, j = (0, i) if i < n0 else (1, i - n0)
                return ("wd", a, j // plan["tdn"][a], j % plan["tdn"][a])

            walk(layer, "adapter_down", n0 + plan["cdn"] * plan["tdn"][1], down)
            u0 = plan["cup"][0] * plan["td"]

            def up(i):
                a, j = (0, i) if i < u0 else (1, i - u0)
                return ("wu", a, j // plan["td"], j % plan["td"])

            walk(layer, "adapter_up", u0 + plan["cup"][1] * plan["td"], up)
        if layer < in_until:
            walk(layer, "in_proj", plan["cin"] * plan["ti"],
                 lambda i: ("in_proj", i // plan["ti"], i % plan["ti"]))
    return out


def stream_barriers(n_layers: int, adapters: bool) -> int:
    """Grid barriers of a K8 launch: after phases 1, 2 (and 3, 4 with an
    adapter) of every layer and after phase 5 of all but the last."""
    return n_layers * (4 if adapters else 2) + n_layers - 1


def _check_stack(name: str, t: torch.Tensor, shape, dtype, device, align: int = 16) -> None:
    _check_cuda(name, t, dtype, device)
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous {tuple(shape)} with a {align}-byte "
                         f"aligned base, got {tuple(t.shape)}")


def _launch(mode: str, *, fused_in, x, u_in, sincos, k_cache, v_cache, kv_scales, cache_pos,
            w_dual, w_in, b_fc_in, b_fc_out, ln_g, ln_b, l0, l1, in_until, n_heads, fz_attn,
            attn_src, fz_mlp, mlp_src, o_bias, scale, ln_eps, stamps=None):
    """Check every operand and launch ``csrc/decode_layer.cu`` over layers
    [l0, l1); ``stamps`` (an int64 (grid, l1 - l0, 5, 2) tensor) launches the
    stamped build.  Returns (y, u, fused or None, k_new, v_new)."""
    dev = fused_in.device
    bf = torch.bfloat16
    L, b, max_len, h, hd = k_cache.shape
    F_ = b_fc_in.shape[-1]
    D = h * hd
    wf = _weight_format(w_dual)
    if b != 1 or not _layer_geometry_ok(n_heads, hd, F_, max_len, w_dual) or (
            w_in is not None and (_weight_format(w_in) != wf or not _inproj_ok(D, w_in))):
        raise ValueError(f"the decode-layer kernel does not take this geometry: b={b}, "
                         f"{n_heads} heads of {hd}, d_ff={F_}, max_len={max_len}, {wf} weights "
                         f"(it takes b=1, head_dim {HEAD_DIM}, n_heads % 8 == 0, max_len % "
                         f"{MAX_LEN_ALIGN} == 0, matching int4 or int8 payloads)")
    kv8 = kv_scales is not None
    cache_dt = torch.int8 if kv8 else bf
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_stack(name, t, (L, 1, max_len, h, hd), cache_dt, dev)
    if kv8:
        for name, t in zip(("k_scale", "v_scale"), kv_scales):
            _check_stack(name, t, (L, 1, h, max_len), bf, dev)
    _check_stack("fused_in", fused_in, (1, 3 * D + F_), bf, dev)
    _check_stack("x", x, (1, D), bf, dev)
    if u_in is not None:
        _check_stack("u_in", u_in, (1, D), bf, dev)
    sin, cos = (t.reshape(-1) for t in sincos)
    rd = 2 * sin.shape[0]
    for name, t in (("sin", sin), ("cos", cos)):
        _check_stack(name, t, (rd // 2,), torch.float32, dev, align=4)
    if rd > hd:
        raise ValueError(f"rotary dim {rd} exceeds head_dim {hd}")
    pos = torch.as_tensor(cache_pos).reshape(-1)
    _check_stack("cache_pos", pos, (1,), torch.int32, dev, align=4)
    _check_stack("b_fc_in", b_fc_in, (L, F_), torch.float32, dev)
    for name, t in (("b_fc_out", b_fc_out), ("ln_g", ln_g), ("ln_b", ln_b)) + (
            (("o_bias", o_bias),) if o_bias is not None else ()):
        _check_stack(name, t, (L, D), torch.float32, dev)
    if wf == "int4":
        _check_stack("w_dual q4", w_dual["q4"], (L, (D + F_) // 2, D), torch.int8, dev)
        _check_stack("w_dual s4", w_dual["s4"], (L, (D + F_) // INT4_GROUP, D), torch.float32, dev)
        qd, sd = w_dual["q4"], w_dual["s4"]
    else:
        _check_stack("w_dual q", w_dual["q"], (L, D + F_, D), torch.int8, dev)
        _check_stack("w_dual s", w_dual["s"], (L, 2, D), torch.float32, dev)
        qd, sd = w_dual["q"], w_dual["s"]
    ni, qi, si = 0, None, None
    if w_in is not None:
        if wf == "int4":
            qi, si = w_in["q4"], w_in["s4"]
            ni = qi.shape[-1]
            _check_stack("w_in q4", qi, (L, D // 2, ni), torch.int8, dev)
            _check_stack("w_in s4", si, (L, D // INT4_GROUP, ni), torch.float32, dev)
        else:
            qi, si = w_in["q"], w_in["s"]
            ni = qi.shape[-1]
            _check_stack("w_in q", qi, (L, D, ni), torch.int8, dev)
            _check_stack("w_in s", si, (L, ni), torch.float32, dev)
        if ni != 3 * D + F_:
            raise ValueError(f"the in_proj is {ni} wide, fused is {3 * D + F_}")
    adapters = {}
    for tag, fz, src in (("a", fz_attn, attn_src), ("m", fz_mlp, mlp_src)):
        if src not in ("out", "in"):
            raise ValueError(f"adapter src must be 'out' or 'in', got {src!r}")
        if fz is None:
            adapters[tag] = (0, 0, None)
            continue
        dh = fz["wd"].shape[2]
        if _adapter_bk(D, dh) is None or dh % KERNEL_ALIGN:
            raise ValueError(f"adapter hidden width {dh} is not a multiple of {KERNEL_ALIGN}")
        if src == "in" and u_in is None:
            raise ValueError("an adapter fed from u_in needs u_in")
        _check_stack(f"{tag} wd", fz["wd"], (L, D, dh), torch.int8, dev)
        _check_stack(f"{tag} wu", fz["wu"], (L, dh, D), torch.int8, dev)
        for k, n in (("sd", dh), ("bd", dh), ("su", D), ("bu", D)):
            _check_stack(f"{tag} {k}", fz[k], (L, 1, n), torch.float32, dev)
        adapters[tag] = (dh, int(src == "in"), fz)

    # outputs, then one workspace carved into the scratch
    n_rows = l1 - l0
    y, u = torch.empty((1, D), dtype=bf, device=dev), torch.empty((1, D), dtype=bf, device=dev)
    fused = torch.empty((1, ni), dtype=bf, device=dev) if ni else None
    k_new = torch.empty((n_rows, 1, D), dtype=bf, device=dev)
    v_new = torch.empty((n_rows, 1, D), dtype=bf, device=dev)
    plan = stream_plan(d=D, f=F_, ni=ni, h=h, wf=wf,
                       dh=(adapters["a"][0], adapters["m"][0]))
    if stamps is not None:
        _check_stack("stamps", stamps, (decode_layers_grid(), l1 - l0, len(PHASES), 2),
                     torch.int64, dev)
    sizes = {  # name: (elements, bytes an element)
        "part": (h * (max_len // ATT_CHUNK) * (hd + 2), 4),
        "terms": (plan["terms"], 4),
        "y2": (D, 2), "ctx": (D, 2), "mh": (F_, 2), "ab": (D, 2), "mb": (D, 2),
        "a_h": (adapters["a"][0], 2), "m_h": (adapters["m"][0], 2),
        "codes": (D + F_, 1), "xsc": ((D + F_) // 256, 4),
        "counters": (plan["counters"] + 1, 4),  # and the grid barrier's
    }
    offsets, total = {}, 0
    for name, (n, es) in sizes.items():
        offsets[name] = total
        total += -(-n * es // 256) * 256  # 256-byte aligned
    work = torch.empty(total, dtype=torch.uint8, device=dev)
    ptrs = {name: (work.data_ptr() + offsets[name] if sizes[name][0] else None)
            for name in sizes}
    if mode == "all":
        # K8 chains the next layer's fused through scratch; its u is scratch
        chain = torch.empty((1, ni), dtype=bf, device=dev)
        ptrs["fused"] = chain.data_ptr()
    else:
        ptrs["fused"] = None if fused is None else fused.data_ptr()

    def ptr(t):
        return None if t is None else t.data_ptr()

    for tag in ("a", "m"):
        fz = adapters[tag][2]
        for k in _ADAPTER[:-1]:  # "h" is scratch, set above
            ptrs[f"{tag}_{k}"] = None if fz is None else fz[k].data_ptr()
    ptrs.update(pos=ptr(pos), sin=ptr(sin), cos=ptr(cos), fused_in=ptr(fused_in), x_in=ptr(x),
                u_in=ptr(u_in), k_cache=ptr(k_cache), v_cache=ptr(v_cache),
                k_scale=ptr(kv_scales[0]) if kv8 else None,
                v_scale=ptr(kv_scales[1]) if kv8 else None, qd=ptr(qd), sd=ptr(sd),
                b_fc_in=ptr(b_fc_in), b_fc_out=ptr(b_fc_out), ln_g=ptr(ln_g), ln_b=ptr(ln_b),
                o_bias=ptr(o_bias), qi=ptr(qi), si=ptr(si), y=ptr(y), u=ptr(u),
                k_new=ptr(k_new), v_new=ptr(v_new), stamps=ptr(stamps))
    ints = dict(layers=L, l0=l0, l1=l1, in_until=in_until, heads=h, d=D, f=F_, ni=ni,
                max_len=max_len, rotary=rd, int4=int(wf == "int4"), kv8=int(kv8),
                dh_a=adapters["a"][0], src_a=adapters["a"][1], dh_m=adapters["m"][0],
                src_m=adapters["m"][1], head_dim=hd, chunk=ATT_CHUNK,
                n_counters=plan["counters"], n_terms=plan["terms"])
    iv = (ctypes.c_longlong * len(_INTS))(*(ints[k] for k in _INTS))
    fv = (ctypes.c_float * len(_FLOATS))(float(scale), float(ln_eps))
    pv = (ctypes.c_void_p * len(_PTRS))(*(ptrs[k] for k in _PTRS))
    err = _decode_fn()(len(_INTS), iv, len(_FLOATS), fv, len(_PTRS), pv,
                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode-layer kernel launch failed: cudaError {err}")
    return y, u, fused, k_new, v_new


def decode_layer_kernel(fused_in, x, sincos, k_cache, v_cache, kv_scales, cache_pos, w_dual,
                        b_fc_in, b_fc_out, ln_g, ln_b, layer_idx, *, n_heads, w_in=None,
                        fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out", u_in=None,
                        o_bias=None, scale, ln_eps=1e-5):
    """K7: one decode layer in one launch of ``csrc/decode_layer.cu``, on the
    card.  Returns bf16 (y, u, [fused], k_new, v_new) as
    ``decode_layer_fused``.  Each launch adds one to
    ``decode_layer_kernel.launches``."""
    L = k_cache.shape[0]
    li = _concrete_layer(layer_idx)
    if li is None or not 0 <= li < L or (w_in is not None and li >= L - 1):
        raise ValueError(f"layer_idx={layer_idx} of an {L}-layer stack"
                         f"{' with w_in (reads layer_idx + 1)' if w_in is not None else ''}")
    y, u, fused, k_new, v_new = _launch(
        "one", fused_in=fused_in, x=x, u_in=u_in, sincos=sincos, k_cache=k_cache,
        v_cache=v_cache, kv_scales=kv_scales, cache_pos=cache_pos, w_dual=w_dual, w_in=w_in,
        b_fc_in=b_fc_in, b_fc_out=b_fc_out, ln_g=ln_g, ln_b=ln_b, l0=li, l1=li + 1,
        in_until=li + 1 if w_in is not None else li, n_heads=n_heads, fz_attn=fz_attn,
        attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src, o_bias=o_bias, scale=scale,
        ln_eps=ln_eps)
    decode_layer_kernel.launches += 1
    if fused is None:
        return y, u, k_new[0], v_new[0]
    return y, u, fused, k_new[0], v_new[0]


def decode_all_layers_kernel(fused0, x0, u0, sincos, k_cache, v_cache, kv_scales, cache_pos,
                             w_dual, w_in, b_fc_in, b_fc_out, ln_g, ln_b, *, n_heads,
                             fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out",
                             o_bias=None, scale, ln_eps=1e-5):
    """K8: all layers of a decode step in one launch of
    ``csrc/decode_layer.cu``, on the card.  Returns bf16 (y (1, D),
    k_new (L, 1, D), v_new (L, 1, D)).  Each launch adds one to
    ``decode_all_layers_kernel.launches``."""
    with obs.span("kernel.k8", M=x0.shape[0]):
        L = k_cache.shape[0]
        if w_in is None and L > 1:
            raise ValueError("decode_all_layers needs w_in: layers 0..L-2 run the next in_proj")
        y, _, _, k_new, v_new = _launch(
            "all", fused_in=fused0, x=x0, u_in=u0, sincos=sincos, k_cache=k_cache, v_cache=v_cache,
            kv_scales=kv_scales, cache_pos=cache_pos, w_dual=w_dual, w_in=w_in, b_fc_in=b_fc_in,
            b_fc_out=b_fc_out, ln_g=ln_g, ln_b=ln_b, l0=0, l1=L, in_until=L - 1, n_heads=n_heads,
            fz_attn=fz_attn, attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src, o_bias=o_bias,
            scale=scale, ln_eps=ln_eps)
    decode_all_layers_kernel.launches += 1
    return y, k_new, v_new


for _fn in (decode_layer_kernel, decode_all_layers_kernel):
    _fn.launches = 0


def decode_all_layers_stamped(fused0, x0, u0, sincos, k_cache, v_cache, kv_scales, cache_pos,
                              w_dual, w_in, b_fc_in, b_fc_out, ln_g, ln_b, *, n_heads,
                              fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out",
                              o_bias=None, scale, ln_eps=1e-5):
    """For measurement only, never on the serving path: K8's stamped build,
    whose every block writes the card's %globaltimer (ns) at the start and
    the end of each phase of each layer.  The arguments as
    ``decode_all_layers_kernel``; CUDA tensors only.  Returns (y, k_new,
    v_new, stamps (grid, L, 5, 2) int64; phases in ``PHASES`` order, 0 where
    a layer has no such phase).  Counts no launch."""
    L = k_cache.shape[0]
    stamps = torch.zeros((decode_layers_grid(), L, len(PHASES), 2), dtype=torch.int64,
                         device=fused0.device)
    y, _, _, k_new, v_new = _launch(
        "all", fused_in=fused0, x=x0, u_in=u0, sincos=sincos, k_cache=k_cache, v_cache=v_cache,
        kv_scales=kv_scales, cache_pos=cache_pos, w_dual=w_dual, w_in=w_in, b_fc_in=b_fc_in,
        b_fc_out=b_fc_out, ln_g=ln_g, ln_b=ln_b, l0=0, l1=L, in_until=L - 1, n_heads=n_heads,
        fz_attn=fz_attn, attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src, o_bias=o_bias,
        scale=scale, ln_eps=ln_eps, stamps=stamps)
    return y, k_new, v_new, stamps


def phase_breakdown(stamps: torch.Tensor) -> Dict[str, float]:
    """Per phase, summed over the layers, in ms: the phase's time (the
    slowest block's end minus the first block's start, which is the release
    of the barrier before it) and the barrier's after it (the first block's
    start of the next phase minus the slowest end).  ``stamps`` as
    ``decode_all_layers_stamped`` returns them; phases a layer lacks (all
    blocks 0) count nothing."""
    st = stamps.to(torch.float64).cpu()
    L = st.shape[1]
    out = {name: 0.0 for name in PHASES}
    out.update({f"{name} barrier": 0.0 for name in PHASES})
    seq = [(l, ph) for l in range(L) for ph in range(len(PHASES)) if bool((st[:, l, ph] > 0).all())]
    for i, (l, ph) in enumerate(seq):
        start, end = st[:, l, ph, 0].min(), st[:, l, ph, 1].max()
        out[PHASES[ph]] += float(end - start) / 1e6
        if i + 1 < len(seq):
            nl, nph = seq[i + 1]
            out[f"{PHASES[ph]} barrier"] += float(st[:, nl, nph, 0].min() - end) / 1e6
    out["total"] = float(st[:, seq[-1][0], seq[-1][1], 1].max() - st[:, 0, 0, 0].min()) / 1e6
    return out


# ---------------------------------------------------------------------------
# Public entries: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------


def _device_pos(cache_pos, device) -> torch.Tensor:
    """The valid cache length as a (1,) int32 tensor on ``device``."""
    return torch.as_tensor(cache_pos, device=device).to(torch.int32).reshape(1)


def _bf16_rows(*rows):
    return [None if r is None else r.to(torch.bfloat16).contiguous() for r in rows]


def decode_layer_fused(fused_in, x, sincos, k_cache, v_cache, kv_scales, cache_pos, w_dual,
                       b_fc_in, b_fc_out, ln_g, ln_b, layer_idx, *, n_heads, w_in=None,
                       fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out", u_in=None,
                       o_bias=None, scale, ln_eps=1e-5):
    """One whole decoder layer of the b=1 decode step (K7).

    fused_in: (1, 3D + F) bf16, THIS layer's in_proj output; x: (1, D) the
    residual input; u_in: (1, D) this layer's LN output (for adapters fed
    from it).  sincos: (sin, cos), each (1, rotary_dim / 2) fp32, of the
    token's position (``ops.rotary.rotary_sincos``).  k_cache, v_cache: the
    whole stacked (L, 1, max_len, h, hd) cache, bf16 or int8; kv_scales:
    None or the int8 cache's (k_scale, v_scale), each (L, 1, h, max_len).
    cache_pos: the valid cache length (an int or a 0-d or (1,) tensor; the
    kernel reads it on the device).  Weights are the stacked int4 or int8
    serving payloads; b_fc_in (L, F) and the bvecs (L, D).  ``layer_idx``
    must be an integer (any integer type, or a 0-d integer tensor), below
    L - 1 when ``w_in`` (the in_proj stack, for the next layer) is given.

    Returns (y, u, [fused_next (1, NI)], k_new (1, D), v_new (1, D)), bf16;
    k_new is post-rotary."""
    li = _concrete_layer(layer_idx)
    if li is None:
        raise ValueError(f"decode_layer_fused needs a concrete integer layer_idx, got "
                         f"{layer_idx!r}")
    L = k_cache.shape[0]
    if w_in is not None and li >= L - 1:
        raise ValueError(f"w_in set on the last layer: layer_idx={li} would read layer {li + 1} "
                         f"of an {L}-layer stack")
    kw = dict(n_heads=n_heads, w_in=w_in, fz_attn=fz_attn, attn_src=attn_src, fz_mlp=fz_mlp,
              mlp_src=mlp_src, u_in=u_in, o_bias=o_bias, scale=scale, ln_eps=ln_eps)
    if not fused_in.is_cuda:
        return decode_layer_plain(fused_in, x, sincos, k_cache, v_cache, kv_scales, cache_pos,
                                  w_dual, b_fc_in, b_fc_out, ln_g, ln_b, li, **kw)
    fused_in, x, u_in = _bf16_rows(fused_in, x, u_in)
    return decode_layer_kernel(fused_in, x, sincos, k_cache, v_cache, kv_scales,
                               _device_pos(cache_pos, fused_in.device), w_dual,
                               b_fc_in.float().contiguous(), b_fc_out, ln_g, ln_b, li,
                               **dict(kw, u_in=u_in))


def decode_all_layers_fused(fused0, x0, u0, sincos, k_cache, v_cache, kv_scales, cache_pos,
                            w_dual, w_in, b_fc_in, b_fc_out, ln_g, ln_b, *, n_heads,
                            fz_attn=None, attn_src="out", fz_mlp=None, mlp_src="out",
                            o_bias=None, scale, ln_eps=1e-5):
    """Every decoder layer of the b=1 decode step (K8), from layer 0's seeds:
    ``fused0`` (1, 3D + F) = in_proj_0(u0), ``x0`` (1, D) the step's input
    hidden state, ``u0`` (1, D) = ln_1[0](x0).  Other arguments as
    ``decode_layer_fused``; ``w_in`` is the whole in_proj stack.  Returns
    (y (1, D), k_new (L, 1, D), v_new (L, 1, D)), bf16: the last layer's
    output (before ln_f) and every layer's post-rotary K and V rows for the
    caller's bulk cache write."""
    kw = dict(n_heads=n_heads, fz_attn=fz_attn, attn_src=attn_src, fz_mlp=fz_mlp,
              mlp_src=mlp_src, o_bias=o_bias, scale=scale, ln_eps=ln_eps)
    if not fused0.is_cuda:
        return decode_all_layers_plain(fused0, x0, u0, sincos, k_cache, v_cache, kv_scales,
                                       cache_pos, w_dual, w_in, b_fc_in, b_fc_out, ln_g, ln_b,
                                       **kw)
    fused0, x0, u0 = _bf16_rows(fused0, x0, u0)
    return decode_all_layers_kernel(fused0, x0, u0, sincos, k_cache, v_cache, kv_scales,
                                    _device_pos(cache_pos, fused0.device), w_dual, w_in,
                                    b_fc_in.float().contiguous(), b_fc_out, ln_g, ln_b, **kw)
