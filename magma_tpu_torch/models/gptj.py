"""GPT-J decoder in functional PyTorch over layer-stacked parameters.

Port of the bf16 and int8-serving paths of ``magma_tpu/models/gptj.py``:
the reference LM (GPT-J 6B: 28 layers, 16 heads, hidden 4096, rotary dim
64, vocab 50258 padded to 50304) with the parallel attention + FFN block
off one layernorm, the out-proj bias and tied input/output embeddings.

Parameters keep the JAX package's pytree: a dict whose block tensors are
stacked on a leading layer axis, (L, in, out) for projections.  Layer ``i``
is a view ``w[i]``, so the JAX package's scan and closure-constant
machinery has no counterpart here: the layer loop is a Python loop.

``quantize_lm_params`` builds the int8 serving layout (fused [q|k|v|fc_in]
``in_proj``, K-concatenated o/fc_out ``out_proj``, the untied ``lm_head_q``
and fused int8 adapters); ``_block`` then runs the per-layer path that the
JAX package takes off the TPU (``gptj.py:1219-1237``): K2b for in_proj, K4a
for out_proj, K5 for the adapters and K2a for the head, each a CUDA kernel
on the card (``ops/quant.py``).  ``quantize_lm_params_int4`` builds the
int4 layout (the same fusions over nibble-packed W4A8 payloads, the int8
head kept): prefill runs ``_block`` with K3 and K4b, and a decode step of
b <= 8 runs ``_run_decode_boundary``, one K6 launch per layer
(``gptj.py:1046-1115``).

Numerics matched: fp32 layernorm statistics, tanh gelu, the tied head with
fp32 output over ``wte`` whose vocab-padding rows are zero, a bf16 KV cache
(L, b, max_len, h, hd) written once per forward after all layers.
Training (remat), ring/sp attention, the int8 cache, the tensor-parallel
and QLoRA int8 layouts and the whole-layer decode kernels (K7, K8) are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from magma_tpu_torch.models.adapters import AdapterSpec, apply_adapter, init_adapter
from magma_tpu_torch.ops.attention import causal_attention, decode_attention
from magma_tpu_torch.ops.rotary import apply_rotary, rotary_sincos
from magma_tpu_torch.utils import round_up


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    """Static LM architecture config."""

    n_layers: int = 28
    n_heads: int = 16
    d_model: int = 4096
    d_ff: int = 16384
    rotary_dim: int = 64
    vocab_size: int = 50258        # 50257 GPT-2 + <|image|>
    max_seq_len: int = 2048
    ln_eps: float = 1e-5
    attn_out_bias: bool = True     # GPT-Neo-fork out_proj keeps its bias
    scale_attn: bool = True        # scores / sqrt(head_dim)
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    adapter_param_dtype: torch.dtype = torch.float32
    # prefill attention: "flash" (the CUDA kernel; its plain version on
    # CPU tensors) or "xla" (plain einsum + softmax)
    attention_impl: str = "flash"
    mlp_adapter: Optional[AdapterSpec] = None
    attn_adapter: Optional[AdapterSpec] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab_size(self) -> int:
        return round_up(self.vocab_size, 128)

    @classmethod
    def gptj_6b(cls, **overrides) -> "GPTJConfig":
        """The MAGMA LM: GPT-J 6B dims."""
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "GPTJConfig":
        """Small config for tests: same structure, toy dims."""
        base = dict(
            n_layers=2, n_heads=4, d_model=128, d_ff=512, rotary_dim=16,
            vocab_size=50258, max_seq_len=256, attention_impl="xla",
        )
        base.update(overrides)
        return cls(**base)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: GPTJConfig, device=None) -> Dict:
    """Random-init parameter dict, N(0, 0.02), drawn directly in
    ``cfg.param_dtype`` on ``device`` (no fp32 temporaries at 6B)."""
    L, D, F_, Vp = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab_size
    pd = cfg.param_dtype

    def normal(shape, std=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=pd).mul_(std)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=pd)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=pd)

    wte = normal((Vp, D))
    wte[cfg.vocab_size:] = 0  # vocab-padding rows: never looked up or sampled
    params = {
        "wte": wte,
        "blocks": {
            "ln_1": {"scale": ones((L, D)), "bias": zeros((L, D))},
            "attn": {n: normal((L, D, D)) for n in ("q", "k", "v", "o")},
            "mlp": {
                "fc_in": {"kernel": normal((L, D, F_)), "bias": zeros((L, F_))},
                "fc_out": {"kernel": normal((L, F_, D)), "bias": zeros((L, D))},
            },
        },
        "ln_f": {"scale": ones((D,)), "bias": zeros((D,))},
    }
    if cfg.attn_out_bias:
        params["blocks"]["attn"]["o_bias"] = zeros((L, D))
    for key, spec in (("adapter_mlp", cfg.mlp_adapter), ("adapter_attn", cfg.attn_adapter)):
        if spec is not None:
            params["blocks"][key] = init_adapter(
                generator, spec, D, L, cfg.adapter_param_dtype, device)
    return params


def init_kv_cache(cfg: GPTJConfig, batch: int, max_len: int, device=None) -> Dict:
    """Fixed-shape bf16 KV cache: {"k", "v"} each (L, b, max_len, h, hd)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


# ---------------------------------------------------------------------------
# int8 serving layout
# ---------------------------------------------------------------------------


def _quantize_stacked(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(L, K, N) -> {"q" int8 (L, K, N), "s" fp32 (L, N)}, one layer at a
    time so the fp32 temporaries stay one layer big (the JAX package's
    jitted ``lax.map``, whose bytes ``compiled=True`` gives)."""
    from magma_tpu_torch.ops.quant import quantize_int8

    packs = [quantize_int8(w[i], compiled=True) for i in range(w.shape[0])]
    return {"q": torch.stack([p["q"] for p in packs]),
            "s": torch.stack([p["s"] for p in packs])}


def _serving_cast_adapters(params: Dict, mode: str = "bf16") -> Dict:
    """Shrink the adapters for serving, as the JAX package's function of
    this name: ``mode="fused_int8"`` packs each adapter without an LN whose
    dims are multiples of 128 into the {"fused": ...} payload of K5 (the
    scaled_parallel scalar folded into the up scales and bias); the others,
    and every adapter in ``mode="bf16"``, keep down/up in bf16.  A payload
    already fused is left as it is.  The JAX package's opt-in ``"int8"``
    mode (two int8 matmuls per adapter) is not ported.  Mutates params."""
    from magma_tpu_torch.ops.quant import quantize_adapter_fused

    if mode not in ("fused_int8", "bf16"):
        raise NotImplementedError(
            f"adapter serving mode {mode!r}: the port has 'fused_int8' and 'bf16'")
    for key in ("adapter_mlp", "adapter_attn"):
        ad = params["blocks"].get(key)
        if ad is None or "fused" in ad:
            continue
        if mode == "fused_int8" and "ln" not in ad:
            fz = quantize_adapter_fused(ad["down"]["kernel"], ad["down"]["bias"],
                                        ad["up"]["kernel"], ad["up"]["bias"],
                                        out_scale=ad.get("scale"))
            if fz is not None:
                params["blocks"][key] = {"fused": fz}
                continue
        for name in ("down", "up", "ln", "scale"):
            if name in ad:
                ad[name] = ({k: t.to(torch.bfloat16) for k, t in ad[name].items()}
                            if isinstance(ad[name], dict) else ad[name].to(torch.bfloat16))
    return params


def _attach_bvecs(params: Dict) -> None:
    """fp32 vector stacks of the fused decode kernels (K6; K7 and K8 in the
    JAX package): row l of ln_g/ln_b is the LN that follows layer l
    (ln_1[l + 1], ln_f after the last)."""
    blocks = params["blocks"]
    bvecs = {
        "b_fc_out": blocks["mlp"]["fc_out"]["bias"].float(),
        "ln_g": torch.cat([blocks["ln_1"]["scale"][1:].float(),
                           params["ln_f"]["scale"].float()[None]]),
        "ln_b": torch.cat([blocks["ln_1"]["bias"][1:].float(),
                           params["ln_f"]["bias"].float()[None]]),
    }
    if "o_bias" in blocks["attn"]:
        bvecs["o_bias"] = blocks["attn"]["o_bias"].float()
    blocks["bvecs"] = bvecs


def quantize_lm_params(params: Dict) -> Dict:
    """Weight-only int8 serving layout, byte-identical to the JAX
    package's ``quantize_lm_params`` (``gptj.py:344-457``): q/k/v/fc_in
    quantized per layer and concatenated along N into "in_proj"; o and
    fc_out concatenated along K into "out_proj" with (L, 2, N) scales; the
    untied int8 head "lm_head_q" from ``wte``; "bvecs"; the adapters in the
    fused-int8 layout.  Layernorms, biases and ``wte`` (the embedding) keep
    their dtype.  Mutates (and returns) ``params``, dropping the originals
    as it goes.

    Only this serving layout (the JAX defaults fuse_in_proj=True,
    fuse_out_proj=True) is ported: the tensor-parallel layout waits for
    parallelism and the QLoRA layout for training."""
    from magma_tpu_torch.ops.quant import quantize_int8

    params.pop("lm_head_q", None)
    attn, mlp = params["blocks"]["attn"], params["blocks"]["mlp"]
    pieces = [_quantize_stacked(attn.pop(k)) for k in ("q", "k", "v")]
    pieces.append(_quantize_stacked(mlp["fc_in"].pop("kernel")))
    attn["in_proj"] = {"q": torch.cat([p["q"] for p in pieces], dim=-1),
                       "s": torch.cat([p["s"] for p in pieces], dim=-1)}
    del pieces
    o_q = _quantize_stacked(attn.pop("o"))
    f_q = _quantize_stacked(mlp["fc_out"].pop("kernel"))
    attn["out_proj"] = {"q": torch.cat([o_q["q"], f_q["q"]], dim=1),
                        "s": torch.stack([o_q["s"], f_q["s"]], dim=1)}
    del o_q, f_q
    params["lm_head_q"] = quantize_int8(params["wte"].float().T, compiled=True)
    _attach_bvecs(params)
    return _serving_cast_adapters(params, mode="fused_int8")


def _quantize_stacked_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(L, K, N) -> {"q4" (L, K/2, N), "s4" (L, K/group, N)}, one layer at
    a time, with the bytes of the JAX package's jitted ``lax.map``."""
    from magma_tpu_torch.ops.quant import quantize_int4

    packs = [quantize_int4(w[i], compiled=True) for i in range(w.shape[0])]
    return {"q4": torch.stack([p["q4"] for p in packs]),
            "s4": torch.stack([p["s4"] for p in packs])}


def quantize_lm_params_int4(params: Dict) -> Dict:
    """Weight-only int4 serving layout, byte-identical to the JAX package's
    ``quantize_lm_params_int4`` (``gptj.py:460-547``): q/k/v/fc_in packed
    per layer and concatenated along N into "in_proj", o and fc_out along
    the packed rows into "out_proj" (their group scales likewise), the int8
    head "lm_head_q", "bvecs" and fused-int8 adapters.  Must start from
    full-precision weights.  Mutates (and returns) ``params``.

    JAX's step-major copies of the scales ("dsb", "dsb2",
    ``_pack_boundary_scales``) are not built: they spare the TPU sub-32 KB
    DMAs, while a CUDA kernel indexes "s4" directly."""
    from magma_tpu_torch.ops.quant import quantize_int8

    attn, mlp = params["blocks"]["attn"], params["blocks"]["mlp"]
    if "qkv" in attn or "in_proj" in attn:
        raise ValueError("params already int8-quantized; int4 must start from "
                         "full-precision weights")
    params.pop("lm_head_q", None)
    pieces = [_quantize_stacked_int4(attn.pop(k)) for k in ("q", "k", "v")]
    pieces.append(_quantize_stacked_int4(mlp["fc_in"].pop("kernel")))
    attn["in_proj"] = {"q4": torch.cat([p["q4"] for p in pieces], dim=-1),
                       "s4": torch.cat([p["s4"] for p in pieces], dim=-1)}
    del pieces
    o_q = _quantize_stacked_int4(attn.pop("o"))
    f_q = _quantize_stacked_int4(mlp["fc_out"].pop("kernel"))
    attn["out_proj"] = {"q4": torch.cat([o_q["q4"], f_q["q4"]], dim=1),
                        "s4": torch.cat([o_q["s4"], f_q["s4"]], dim=1)}
    del o_q, f_q
    params["lm_head_q"] = quantize_int8(params["wte"].float().T, compiled=True)
    _attach_bvecs(params)
    return _serving_cast_adapters(params, mode="fused_int8")


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p: Dict, eps: float, out_dtype) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(out_dtype)


def _mm(x: torch.Tensor, w, cdt) -> torch.Tensor:
    """Matmul dispatching on the weight leaf, as the JAX package's ``_mm``:
    a tensor (x @ w in cdt, promoted as ``jnp.dot`` promotes: a bf16 decode
    attention output meets fp32 weights as fp32), an int8 {"q", "s"} pack
    (K2a), the same with "idx" (layer ``idx`` of a stacked pack, K2b), or a
    stacked int4 {"q4", "s4", "idx"} pack (K3)."""
    if isinstance(w, dict):
        from magma_tpu_torch.ops.quant import (int4_matmul_stacked, int8_matmul,
                                               int8_matmul_stacked)

        if "q4" in w:
            return int4_matmul_stacked(x, w["q4"], w["s4"], w["idx"], out_dtype=cdt)
        if "idx" in w:
            return int8_matmul_stacked(x, w["q"], w["s"], w["idx"], out_dtype=cdt)
        return int8_matmul(x, w["q"], w["s"], out_dtype=cdt)
    dt = torch.promote_types(x.dtype, cdt)
    return x.to(dt) @ w.to(dt)


def _layer_views(blocks: Dict, n_layers: int) -> List[Dict]:
    """Layer-stacked tree -> one dict of (L-axis) views per layer.

    Quantized packs ({"q", "s"}) and fused adapter payloads stay stacked
    and carry their layer as "idx", which the stacked kernels read through
    the layer's view: no copy, and none of the JAX package's closure
    machinery (``_run_blocks_quantized``)."""

    def split(t):
        if isinstance(t, dict):
            if {"q", "s"} <= t.keys() or "q4" in t:  # a quantized pack (bf16 attn has no "s")
                return [{**t, "idx": i} for i in range(n_layers)]
            if "fused" in t:
                return [{"fused": t["fused"], "idx": i} for i in range(n_layers)]
            parts = {k: split(v) for k, v in t.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n_layers)]
        return t.unbind(0)

    return split(blocks)


def _block(
    cfg: GPTJConfig,
    bp: Dict,                 # one layer's params (views)
    x: torch.Tensor,          # (b, s, D)
    sin: torch.Tensor,
    cos: torch.Tensor,
    kv_len: Optional[torch.Tensor],
    cache_kv: Optional[Tuple[Dict, int]],
    cache_index,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """One GPT-J block: parallel attention + FFN off a single layernorm.

    With ``cache_kv = (cache, layer)``: s > 1 is a prefill over fresh keys,
    s == 1 a decode step that reads the layer's cache; either way the new
    K/V are returned for the bulk write in ``forward``."""
    b, s, D = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    scale = (1.0 / hd ** 0.5) if cfg.scale_attn else 1.0

    u = _layer_norm(x, bp["ln_1"], cfg.ln_eps, cdt)
    m_pre = None
    if "in_proj" in bp["attn"]:
        # serving layout: [q | k | v | fc_in] off the same u in one launch
        fused = _mm(u, bp["attn"]["in_proj"], cdt)
        m_pre = fused[..., 3 * D:]
        q, kk, v = (t.reshape(b, s, h, hd) for t in fused[..., :3 * D].split(D, -1))
    else:
        q = _mm(u, bp["attn"]["q"], cdt).reshape(b, s, h, hd)
        kk = _mm(u, bp["attn"]["k"], cdt).reshape(b, s, h, hd)
        v = _mm(u, bp["attn"]["v"], cdt).reshape(b, s, h, hd)
    q = apply_rotary(q, sin, cos, cfg.rotary_dim)
    kk = apply_rotary(kk, sin, cos, cfg.rotary_dim)

    new_kv = None
    if cache_kv is None or s > 1:
        attn = causal_attention(q, kk, v, scale=scale, impl=cfg.attention_impl,
                                kv_len=kv_len)
    else:
        cache, layer = cache_kv
        attn = decode_attention(q, cache["k"][layer], cache["v"][layer], cache_index,
                                scale=scale, self_kv=(kk, v))
    if cache_kv is not None:
        new_kv = (kk.to(cdt), v.to(cdt))

    ctx = attn.reshape(b, s, D)
    if "out_proj" in bp["attn"]:
        # serving layout: o_proj and fc_out over one weight stream in one
        # launch, their outputs apart for the per-branch adapters
        from magma_tpu_torch.ops.quant import dual_matmul_stacked

        w = bp["attn"]["out_proj"]
        mh = F.gelu(m_pre + bp["mlp"]["fc_in"]["bias"].to(cdt), approximate="tanh")
        a, m = dual_matmul_stacked(ctx, mh, w, w["idx"], out_dtype=cdt)
    else:
        a = _mm(ctx, bp["attn"]["o"], cdt)
        if m_pre is None:
            m_pre = _mm(u, bp["mlp"]["fc_in"]["kernel"], cdt)
        m = F.gelu(m_pre + bp["mlp"]["fc_in"]["bias"].to(cdt), approximate="tanh")
        m = _mm(m, bp["mlp"]["fc_out"]["kernel"], cdt)

    if "o_bias" in bp["attn"]:
        a = a + bp["attn"]["o_bias"].to(cdt)
    a = apply_adapter(bp.get("adapter_attn"), cfg.attn_adapter, u, a, cdt)
    m = m + bp["mlp"]["fc_out"]["bias"].to(cdt)
    m = apply_adapter(bp.get("adapter_mlp"), cfg.mlp_adapter, u, m, cdt)
    return x + a + m, new_kv


def _boundary_ok(cfg: GPTJConfig, blocks: Dict, x: torch.Tensor) -> bool:
    """Can this step take the boundary decode (``gptj.py:934-956``)?  A
    decode step (s == 1) of b <= 8 rows over the int4 layout with "bvecs",
    every configured adapter fused."""
    if x.shape[1] != 1 or x.shape[0] > 8 or "bvecs" not in blocks:
        return False
    for k in ("in_proj", "out_proj"):
        w = blocks["attn"].get(k)
        if not (isinstance(w, dict) and "q4" in w):
            return False
    return all(spec is None or "fused" in blocks.get(name, {})
               for name, spec in (("adapter_mlp", cfg.mlp_adapter),
                                  ("adapter_attn", cfg.attn_adapter)))


def _run_decode_boundary(cfg: GPTJConfig, blocks: Dict, x: torch.Tensor, sin, cos,
                         cache: Dict, cache_index):
    """A decode step over boundary launches (``gptj.py:1046-1115``): layer
    0's ln_1 and in_proj (K3), then per layer the rotary, the cache
    attention and the gelu in torch and one ``boundary_fused_stacked`` (K6)
    for the dual, the adapters, the residual, the next LN and the next
    in_proj.  Returns (x, new keys, new values), the caller writes the
    cache."""
    from magma_tpu_torch.ops.quant import boundary_fused_stacked, int4_matmul_stacked

    L, D = cfg.n_layers, cfg.d_model
    b = x.shape[0]
    cdt = cfg.compute_dtype
    h, hd = cfg.n_heads, cfg.head_dim
    scale = (1.0 / hd ** 0.5) if cfg.scale_attn else 1.0
    attn_w, bv = blocks["attn"], blocks["bvecs"]
    fc_in_b = blocks["mlp"]["fc_in"]["bias"]

    def adapter_of(name, spec):
        if spec is None:
            return None, "out"
        return blocks[name]["fused"], "out" if spec.adapter_type == "normal" else "in"

    fz_mlp, mlp_src = adapter_of("adapter_mlp", cfg.mlp_adapter)
    fz_attn, attn_src = adapter_of("adapter_attn", cfg.attn_adapter)
    x2 = x.reshape(b, D)
    u2 = _layer_norm(x2, {"scale": blocks["ln_1"]["scale"][0],
                          "bias": blocks["ln_1"]["bias"][0]}, cfg.ln_eps, cdt)
    fused = int4_matmul_stacked(u2, attn_w["in_proj"]["q4"], attn_w["in_proj"]["s4"], 0,
                                out_dtype=cdt)
    k_news, v_news = [], []
    for l in range(L):
        q, kk, v = (t.reshape(b, 1, h, hd) for t in fused[:, :3 * D].split(D, -1))
        q = apply_rotary(q, sin, cos, cfg.rotary_dim)
        kk = apply_rotary(kk, sin, cos, cfg.rotary_dim)
        k_news.append(kk.to(cdt))
        v_news.append(v.to(cdt))
        ctx2 = decode_attention(q, cache["k"][l], cache["v"][l], cache_index, scale=scale,
                                self_kv=(kk, v)).reshape(b, D)
        mh2 = F.gelu(fused[:, 3 * D:] + fc_in_b[l].to(cdt), approximate="tanh")
        outs = boundary_fused_stacked(
            ctx2, mh2, x2, attn_w["out_proj"], bv["b_fc_out"], bv["ln_g"], bv["ln_b"], l,
            w_in=None if l == L - 1 else attn_w["in_proj"], fz_attn=fz_attn,
            attn_src=attn_src, fz_mlp=fz_mlp, mlp_src=mlp_src, u_in=u2,
            o_bias=bv.get("o_bias"), ln_eps=cfg.ln_eps)
        if l == L - 1:
            x2, u2 = outs  # u2 is ln_f(x2); forward applies ln_f itself
        else:
            x2, u2, fused = outs
    return x2.reshape(b, 1, D).to(cdt), k_news, v_news


def _write_cache(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 cache_index) -> Dict:
    """Write all layers' new K/V, (L, b, s, h, hd), into the cache at
    ``cache_index`` (an int, a scalar tensor, or per-row (b,)).  Updates
    the cache in place (the JAX package returns a new one) and returns it."""
    b, s = k_new.shape[1:3]
    dev = cache["k"].device
    start = torch.as_tensor(cache_index, device=dev).to(torch.long).reshape(-1, 1)
    pos = (start + torch.arange(s, device=dev)).expand(b, s)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    cache["k"][:, rows, pos] = k_new.to(cache["k"].dtype)
    cache["v"][:, rows, pos] = v_new.to(cache["v"].dtype)
    return cache


def forward(
    cfg: GPTJConfig,
    params: Dict,
    inputs_embeds: torch.Tensor,      # (b, s, D)
    *,
    positions: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
    cache_index=None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """LM forward from embeddings.  Returns (fp32 logits, cache), or
    (hidden after ln_f, cache) with ``return_hidden=True``.  ``cache`` is
    updated in place."""
    b, s, _ = inputs_embeds.shape
    cdt = cfg.compute_dtype
    x = inputs_embeds.to(cdt)
    dev = x.device
    if positions is None:
        start = torch.as_tensor(0 if cache_index is None else cache_index, device=dev)
        positions = (start.reshape(-1, 1) + torch.arange(s, device=dev)).expand(b, s)
    sin, cos = rotary_sincos(positions, cfg.rotary_dim)

    blocks = params["blocks"]
    if cache is not None and _boundary_ok(cfg, blocks, x):
        x, k_news, v_news = _run_decode_boundary(cfg, blocks, x, sin, cos, cache, cache_index)
    else:
        k_news, v_news = [], []
        for i, bp in enumerate(_layer_views(blocks, cfg.n_layers)):
            x, new_kv = _block(cfg, bp, x, sin, cos, kv_len,
                               None if cache is None else (cache, i), cache_index)
            if new_kv is not None:
                k_news.append(new_kv[0])
                v_news.append(new_kv[1])
    if cache is not None:
        cache = _write_cache(cache, torch.stack(k_news), torch.stack(v_news), cache_index)

    x = _layer_norm(x, params["ln_f"], cfg.ln_eps, cdt)
    if return_hidden:
        return x, cache
    return lm_head(cfg, params, x), cache


def lm_head(cfg: GPTJConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """Hidden states -> fp32 logits: the int8 head ``lm_head_q`` (K2a)
    when ``quantize_lm_params`` made one, else the tied (padded) ``wte``,
    the product accumulated in fp32 and returned unrounded, as
    ``preferred_element_type=float32`` gives it in the JAX package."""
    if "lm_head_q" in params:
        return _mm(hidden, params["lm_head_q"], torch.float32)
    w = params["wte"].to(hidden.dtype)
    if hidden.dtype == torch.float32:
        return hidden @ w.T
    if hidden.is_cuda:
        flat = hidden.reshape(-1, hidden.shape[-1])
        out = torch.mm(flat, w.T, out_dtype=torch.float32)
        return out.reshape(*hidden.shape[:-1], w.shape[0])
    return hidden.float() @ w.float().T


def embed_tokens(cfg: GPTJConfig, params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> word embeddings in the compute dtype."""
    return F.embedding(ids, params["wte"]).to(cfg.compute_dtype)


def logits_mask(cfg: GPTJConfig, device=None) -> torch.Tensor:
    """Boolean (padded_vocab,) -- True for real vocab entries."""
    return torch.arange(cfg.padded_vocab_size, device=device) < cfg.vocab_size
