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
(``gptj.py:1046-1115``).  A b=1 decode step over either quantized layout
takes ``_run_decode_fused_layers`` ahead of both (``gptj.py:981-1043``):
layer 0's LN and in_proj, then all layers in one K8 launch
(``ops/decode_layer.py``), on the CPU its plain version.

Numerics matched: fp32 layernorm statistics, tanh gelu, the tied head with
fp32 output over ``wte`` whose vocab-padding rows are zero, a KV cache
(L, b, max_len, h, hd) written once per forward after all layers: bf16, or
with ``kv_cache_dtype="int8"`` int8 codes with one bf16 scale per (layer,
row, head, position), stored position-minor (L, b, h, max_len).
Training: ``forward`` without a cache is differentiable (flash attention
through K1/K9a/K9b, the int8 products through K2a/K2b and K10), with remat
as ``torch.utils.checkpoint`` around each layer; ``quantize_lm_params(
fuse_out_proj=False)`` builds the QLoRA layout (in_proj fused, o and
fc_out separate int8 stacks, bf16 adapters).  Serving:
``forward(read_history=True)`` runs a chunk of s > 1 fresh positions
against the cache history ``[0, cache_index)`` and causally against itself
(``ops/attention.history_attention``: the chunked prefill of split
generate and of the serving engine), and ``_write_cache`` clamps each
row's start into ``[0, max_len - s]`` as ``dynamic_update_slice`` does.

Parallelism (``forward(..., mesh=...)``, ``parallel/``): the rank holds
its shards of the tree (``parallel/sharding.py``), h / tp heads.  Tensor
parallelism is Megatron's: q/k/v/fc_in are column shards and o/fc_out
row shards whose partial outputs are summed over "tp" in one all_reduce
a layer (``mesh.reduce_from``; the column inputs enter through
``mesh.copy_to``, so the backward sums their gradients), the replicated
biases and the adapters run after the sum, the embedding and the head are
vocab shards (the gathered logits are the unsharded path's).  The fused
decode paths (K8, K6) stand down under tp: the tensor-parallel int8
layout (``quantize_lm_params(fuse_in_proj=False)``) has no in_proj, and
each projection runs K2b.  ``attention_impl="ring"`` without a cache
runs ring attention over the rank's sequence shard
(``parallel/ring_attention.py``); a cached step with an sp axis > 1 reads
a position-sharded cache through ``parallel/sp_decode.py``.
``pack_lm_params_bf16`` is not ported.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from magma_tpu_torch.models.adapters import AdapterSpec, apply_adapter, init_adapter
from magma_tpu_torch.ops.attention import causal_attention, decode_attention, history_attention
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
    # CPU tensors), "xla" (plain einsum + softmax) or "ring" (the sequence
    # sharded over the mesh's ``sp_axis``: ring attention without a cache,
    # the position-sharded cache with one; needs ``forward(..., mesh=...)``)
    attention_impl: str = "flash"
    sp_axis: str = "sp"            # mesh axis ring attention shards over
    # "bf16" or "int8" (per-(position, head) scales; halves the cache stream)
    kv_cache_dtype: str = "bf16"
    # recompute each layer in the backward (torch.utils.checkpoint) instead
    # of keeping its activations
    remat: bool = True
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
            remat=False,
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


def init_kv_cache(cfg: GPTJConfig, batch: int, max_len: int, device=None,
                  mesh=None) -> Dict:
    """Fixed-shape KV cache: {"k", "v"} each (L, b, max_len, h, hd) in bf16,
    or with ``cfg.kv_cache_dtype == "int8"`` int8 codes plus "k_scale" and
    "v_scale", bf16 (L, b, h, max_len): position-minor, so a head's scales
    for all positions are one contiguous row (see ``_quantize_kv``).  With
    a ``mesh``, this rank's shard: h / tp heads (``sharding.kv_cache_spec``)
    and, when the sequence-sharded cache is active, max_len / sp positions."""
    h = cfg.n_heads
    if mesh is not None:
        h //= mesh.size("tp")
        if _sp_cache_active(cfg, mesh):
            sp = mesh.size(cfg.sp_axis)
            if max_len % sp:
                raise ValueError(f"max_len {max_len} is not divisible by {cfg.sp_axis}={sp}")
            max_len //= sp
    shape = (cfg.n_layers, batch, max_len, h, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sc_shape = (cfg.n_layers, batch, h, max_len)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sc_shape, dtype=torch.bfloat16, device=device),
            "v_scale": torch.zeros(sc_shape, dtype=torch.bfloat16, device=device),
        }
    if cfg.kv_cache_dtype != "bf16":
        raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {cfg.kv_cache_dtype!r}")
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # fp32(1/127)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(layer, row, position, head) symmetric int8: x (L, b, s, h, hd)
    -> (int8 codes of x's shape, bf16 scales (L, b, h, s)), with the bytes
    of the JAX function under ``jit`` (``gptj.py:201-221``), where XLA turns
    the division by 127 into a product with fp32(1/127) and keeps the true
    division of x by the scale."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) * _INV_127
    # a divisor of x's shape: a scalar divisor may be taken as a product
    # with its reciprocal (PyTorch's CUDA division does), not IEEE division
    q = torch.clamp(torch.round(xf / scale.expand_as(xf)), -127, 127).to(torch.int8)
    return q, scale[..., 0].transpose(-1, -2).to(torch.bfloat16).contiguous()


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
    this name (``gptj.py:255-317``): ``mode="fused_int8"`` packs each
    adapter without an LN whose dims are multiples of 128 into the
    {"fused": ...} payload of K5 (the scaled_parallel scalar folded into
    the up scales and bias); the others, and every adapter in
    ``mode="bf16"``, keep down/up in bf16.  ``mode="int8"`` (opt-in, for
    deployments short of memory) packs each bottleneck kernel (L, K, N) with
    K and N multiples of 128 as a stacked int8 {"q", "s"} pack, whose two
    products run on K2b (``adapters._proj``), and keeps everything else
    (biases, LN, scale, kernels off that geometry) in bf16; with such
    adapters the fused decodes (K8, K6) stand down.  A payload already
    fused is left as it is, except in "int8" mode, which needs the
    down/up masters and raises.  Mutates params."""
    from magma_tpu_torch.ops.quant import quantize_adapter_fused, quantize_int8

    if mode not in ("fused_int8", "bf16", "int8"):
        raise ValueError(f"adapter serving mode {mode!r}: 'fused_int8', 'bf16' or 'int8'")

    def kernel(t):
        # the lane guard of the JAX package (K, N % 128); JAX calls
        # quantize_int8 here outside jit, so the eager bytes
        if (mode == "int8" and t.dim() == 3 and t.shape[-1] % 128 == 0
                and t.shape[-2] % 128 == 0):
            return quantize_int8(t)
        return t.to(torch.bfloat16)

    for key in ("adapter_mlp", "adapter_attn"):
        ad = params["blocks"].get(key)
        if ad is None:
            continue
        if "fused" in ad:
            if mode == "int8":
                raise ValueError(f"{key} is already a fused-int8 serving payload; int8 "
                                 "re-packing needs the bf16 down/up masters (quantize the "
                                 "original params instead)")
            continue
        if mode == "fused_int8" and "ln" not in ad:
            fz = quantize_adapter_fused(ad["down"]["kernel"], ad["down"]["bias"],
                                        ad["up"]["kernel"], ad["up"]["bias"],
                                        out_scale=ad.get("scale"))
            if fz is not None:
                params["blocks"][key] = {"fused": fz}
                continue
        for name in ("down", "up"):
            ad[name] = {"kernel": kernel(ad[name]["kernel"]),
                        "bias": ad[name]["bias"].to(torch.bfloat16)}
        for name in ("ln", "scale"):
            if name in ad:
                ad[name] = ({k: t.to(torch.bfloat16) for k, t in ad[name].items()}
                            if isinstance(ad[name], dict) else ad[name].to(torch.bfloat16))
    return params


def _attach_bvecs(params: Dict) -> None:
    """fp32 vector stacks of the fused decode kernels (K6, K7 and K8): row
    l of ln_g/ln_b is the LN that follows layer l
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


def quantize_lm_params(params: Dict, *, fuse_out_proj: bool = True,
                       fuse_in_proj: bool = True) -> Dict:
    """Weight-only int8 layouts, byte-identical to the JAX package's jitted
    ``quantize_lm_params`` (``gptj.py:344-457``): q/k/v/fc_in quantized per
    layer and concatenated along N into "in_proj" and the untied int8 head
    "lm_head_q" from ``wte``.  ``fuse_out_proj=True`` (serving) also
    concatenates o and fc_out along K into "out_proj" with (L, 2, N)
    scales, adds "bvecs" and packs the adapters in the fused-int8 layout;
    ``fuse_out_proj=False`` (QLoRA training, ``train_lm_int8``) keeps o and
    fc_out as separate int8 stacks, differentiable in their inputs, and the
    adapters in bf16.  ``fuse_in_proj=False`` is the tensor-parallel
    serving layout: q/k/v/o/fc_in/fc_out each a separate int8 stack (each
    takes a clean Megatron spec, ``parallel/sharding.py``), the head, and
    bf16 adapters.  Layernorms, biases and ``wte`` (the embedding) keep
    their dtype.  Mutates (and returns) ``params``, dropping the originals
    as it goes."""
    from magma_tpu_torch.ops.quant import quantize_int8

    params.pop("lm_head_q", None)
    attn, mlp = params["blocks"]["attn"], params["blocks"]["mlp"]
    if not fuse_in_proj:
        for k in ("q", "k", "v", "o"):
            attn[k] = _quantize_stacked(attn[k])
        for k in ("fc_in", "fc_out"):
            mlp[k]["kernel"] = _quantize_stacked(mlp[k]["kernel"])
        params["lm_head_q"] = quantize_int8(params["wte"].float().T, compiled=True)
        return _serving_cast_adapters(params, mode="bf16")
    pieces = [_quantize_stacked(attn.pop(k)) for k in ("q", "k", "v")]
    pieces.append(_quantize_stacked(mlp["fc_in"].pop("kernel")))
    attn["in_proj"] = {"q": torch.cat([p["q"] for p in pieces], dim=-1),
                       "s": torch.cat([p["s"] for p in pieces], dim=-1)}
    del pieces
    if fuse_out_proj:
        o_q = _quantize_stacked(attn.pop("o"))
        f_q = _quantize_stacked(mlp["fc_out"].pop("kernel"))
        attn["out_proj"] = {"q": torch.cat([o_q["q"], f_q["q"]], dim=1),
                            "s": torch.stack([o_q["s"], f_q["s"]], dim=1)}
        del o_q, f_q
    else:
        attn["o"] = _quantize_stacked(attn["o"])
        mlp["fc_out"]["kernel"] = _quantize_stacked(mlp["fc_out"]["kernel"])
    params["lm_head_q"] = quantize_int8(params["wte"].float().T, compiled=True)
    if fuse_out_proj:
        _attach_bvecs(params)
    return _serving_cast_adapters(params, mode="fused_int8" if fuse_out_proj else "bf16")


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


def _sp_cache_active(cfg: GPTJConfig, mesh) -> bool:
    """True when cached generation takes the sequence-sharded cache
    (``gptj.py:607-618``): ``attention_impl="ring"`` and a mesh whose sp
    axis is > 1.  The cache then holds this rank's positions
    (``init_kv_cache(mesh=...)``)."""
    return (mesh is not None and cfg.attention_impl == "ring"
            and cfg.sp_axis in mesh.axis_names and mesh.shape[cfg.sp_axis] > 1)


def _ring_attention(cfg, q, kk, v, kv_len, mesh, scale):
    """Training/no-cache attention over the rank's sequence shard
    (``gptj.py:680-705``)."""
    if mesh is None:
        raise ValueError("attention_impl='ring' needs a mesh: pass forward(..., mesh=...) "
                         "(the Trainer threads it via Magma.mesh)")
    if kv_len is not None:
        raise ValueError("ring attention has no right-padding mask (kv_len); training masks "
                         "via labels instead")
    from magma_tpu_torch.parallel.ring_attention import context_parallel_attention

    batch_axis = "dp" if "dp" in mesh.axis_names else None
    return context_parallel_attention(q, kk, v, mesh, scale=scale, causal=True,
                                      seq_axis=cfg.sp_axis, batch_axis=batch_axis)


def _block(
    cfg: GPTJConfig,
    bp: Dict,                 # one layer's params (views)
    x: torch.Tensor,          # (b, s, D)
    sin: torch.Tensor,
    cos: torch.Tensor,
    kv_len: Optional[torch.Tensor],
    cache_kv: Optional[Tuple[Dict, int]],
    cache_index,
    read_history: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """One GPT-J block: parallel attention + FFN off a single layernorm.

    With ``cache_kv = (cache, layer)``: s > 1 is a prefill over fresh keys
    (with ``read_history``, a chunk that also attends to the cache history
    ``[0, cache_index)``), s == 1 a decode step that reads the layer's
    cache; either way the new K/V are returned for the bulk write in
    ``forward``.  Under a mesh with tp > 1 the layer's params are this
    rank's shards (module docstring)."""
    from magma_tpu_torch.parallel.mesh import copy_to, reduce_from

    b, s, D = x.shape
    hd = cfg.head_dim
    tp = 1 if mesh is None else mesh.size("tp")
    h = cfg.n_heads // tp
    cdt = cfg.compute_dtype
    scale = (1.0 / hd ** 0.5) if cfg.scale_attn else 1.0

    u = _layer_norm(x, bp["ln_1"], cfg.ln_eps, cdt)
    m_pre = None
    if "in_proj" in bp["attn"]:
        if tp > 1:
            raise ValueError("tensor parallelism needs the separate projections: the bf16 "
                             "tree or quantize_lm_params(fuse_in_proj=False)")
        # serving layout: [q | k | v | fc_in] off the same u in one launch
        fused = _mm(u, bp["attn"]["in_proj"], cdt)
        m_pre = fused[..., 3 * D:]
        q, kk, v = (t.reshape(b, s, h, hd) for t in fused[..., :3 * D].split(D, -1))
        u_col = u
    else:
        u_col = copy_to(u, mesh, "tp")  # the column shards' input
        q = _mm(u_col, bp["attn"]["q"], cdt).reshape(b, s, h, hd)
        kk = _mm(u_col, bp["attn"]["k"], cdt).reshape(b, s, h, hd)
        v = _mm(u_col, bp["attn"]["v"], cdt).reshape(b, s, h, hd)
    q = apply_rotary(q, sin, cos, cfg.rotary_dim)
    kk = apply_rotary(kk, sin, cos, cfg.rotary_dim)

    new_kv = None
    sp_cache = _sp_cache_active(cfg, mesh)
    if cache_kv is None:
        if cfg.attention_impl == "ring":
            attn = _ring_attention(cfg, q, kk, v, kv_len, mesh, scale)
        else:
            attn = causal_attention(q, kk, v, scale=scale, impl=cfg.attention_impl,
                                    kv_len=kv_len)
    elif s > 1 and read_history:
        if sp_cache:
            raise ValueError("the sequence-sharded cache has no chunked prefill "
                             "(read_history)")
        cache, layer = cache_kv
        attn = history_attention(q, cache["k"][layer], cache["v"][layer], cache_index, kk, v,
                                 scale=scale, kv_len=kv_len, kv_scales=_layer_scales(cache, layer))
    elif s > 1:
        # prefill: the prompt's own keys.  With the sequence-sharded cache
        # the prompt runs whole on every rank and the cache write keeps each
        # rank's positions; "ring" without it has no cached meaning.  Either
        # way "ring" prefills as JAX's "flash" does, which takes its einsum
        # path at head dims the kernel lacks (attention.py:94-95)
        impl = cfg.attention_impl
        if impl == "ring":
            if not sp_cache:
                import warnings

                warnings.warn(
                    "attention_impl='ring' without a >1-'sp' mesh has no cached-generation "
                    "path; using the flash kernel for prefill/decode (pass mesh= for the "
                    "sequence-sharded cache)", RuntimeWarning, stacklevel=2)
            impl = "flash" if hd % 128 == 0 else "xla"
        attn = causal_attention(q, kk, v, scale=scale, impl=impl, kv_len=kv_len)
    elif sp_cache:
        from magma_tpu_torch.parallel.sp_decode import sp_decode_attention

        cache, layer = cache_kv
        attn = sp_decode_attention(q, cache["k"][layer], cache["v"][layer], cache_index,
                                   (kk, v), mesh, cfg.sp_axis, scale=scale,
                                   kv_scales=_layer_scales(cache, layer))
    else:
        cache, layer = cache_kv
        attn = decode_attention(q, cache["k"][layer], cache["v"][layer], cache_index,
                                scale=scale, self_kv=(kk, v),
                                kv_scales=_layer_scales(cache, layer))
    if cache_kv is not None:
        new_kv = (kk.to(cdt), v.to(cdt))

    ctx = attn.reshape(b, s, h * hd)
    if "out_proj" in bp["attn"]:
        # serving layout: o_proj and fc_out over one weight stream in one
        # launch, their outputs apart for the per-branch adapters
        from magma_tpu_torch.ops.quant import dual_matmul_stacked

        w = bp["attn"]["out_proj"]
        mh = F.gelu(m_pre + bp["mlp"]["fc_in"]["bias"].to(cdt), approximate="tanh")
        a, m = dual_matmul_stacked(ctx, mh, w, w["idx"], out_dtype=cdt)
    else:
        # under tp the row shards' partial sums meet in one all_reduce for
        # both branches: an int8 product's in fp32 (its kernel's output, so
        # the sum rounds once, as one product over the whole K does), the
        # bf16 tree's in the compute dtype
        pdt = torch.float32 if tp > 1 and isinstance(bp["attn"]["o"], dict) else cdt
        a = _mm(ctx, bp["attn"]["o"], pdt)
        if m_pre is None:
            m_pre = _mm(u_col, bp["mlp"]["fc_in"]["kernel"], cdt)
        m = F.gelu(m_pre + bp["mlp"]["fc_in"]["bias"].to(cdt), approximate="tanh")
        m = _mm(m, bp["mlp"]["fc_out"]["kernel"], pdt)
        if tp > 1:
            a, m = (t.to(cdt) for t in
                    reduce_from(torch.cat([a, m], -1), mesh, "tp").split(D, -1))

    if "o_bias" in bp["attn"]:
        a = a + bp["attn"]["o_bias"].to(cdt)
    a = apply_adapter(bp.get("adapter_attn"), cfg.attn_adapter, u, a, cdt)
    m = m + bp["mlp"]["fc_out"]["bias"].to(cdt)
    m = apply_adapter(bp.get("adapter_mlp"), cfg.mlp_adapter, u, m, cdt)
    return x + a + m, new_kv


def _adapters_fused(cfg: GPTJConfig, blocks: Dict) -> bool:
    return all(spec is None or "fused" in blocks.get(name, {})
               for name, spec in (("adapter_mlp", cfg.mlp_adapter),
                                  ("adapter_attn", cfg.attn_adapter)))


def _fused_adapter_kwargs(cfg: GPTJConfig, blocks: Dict) -> Dict:
    """The fused adapter payloads as the boundary and whole-layer decodes
    take them: ``fz_attn``/``fz_mlp`` (None where absent) and their sources
    ``attn_src``/``mlp_src``, "out" for a "normal" adapter (fed by its
    branch's output), "in" for the others (fed by the layer's LN output)."""
    kw = {}
    for tag, spec in (("attn", cfg.attn_adapter), ("mlp", cfg.mlp_adapter)):
        kw[f"fz_{tag}"] = None if spec is None else blocks[f"adapter_{tag}"]["fused"]
        kw[f"{tag}_src"] = "out" if spec is None or spec.adapter_type == "normal" else "in"
    return kw


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
    return _adapters_fused(cfg, blocks)


def _declayer_ok(cfg: GPTJConfig, blocks: Dict, x: torch.Tensor, cache: Dict) -> bool:
    """Can this step take the whole-layer decode (``gptj.py:958-978``)?  A
    b=1 s=1 step over either fused serving layout with "bvecs" and fused
    adapters, at the kernel's geometry (``declayer_supported``).  Only the
    JAX package's TPU test is dropped: the CPU takes the plain version."""
    if x.shape[0] != 1 or x.shape[1] != 1:
        return False
    if "bvecs" not in blocks or not _adapters_fused(cfg, blocks):
        return False
    attn = blocks["attn"]
    if "in_proj" not in attn or "out_proj" not in attn:
        return False
    from magma_tpu_torch.ops.decode_layer import declayer_supported

    return declayer_supported(
        b=1, s=1, n_heads=cfg.n_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        max_len=cache["k"].shape[2], w_in_proj=attn["in_proj"], w_out_proj=attn["out_proj"],
        has_bvecs=True)


def fused_decode(cfg: GPTJConfig, blocks: Dict, x: torch.Tensor, cache: Optional[Dict],
                 mesh=None, read_history: bool = False) -> Optional[str]:
    """The fused decode that ``forward`` runs for ``x`` over ``cache``:
    "declayer" (all layers in one K8 launch, ``_declayer_ok``), "boundary"
    (one K6 launch a layer, ``_boundary_ok``) or None (layer by layer).  The
    single-chip fused decodes assume the whole cache and in_proj are local:
    they stand down under the sequence-sharded cache (and tp has no
    in_proj), and for a chunk that reads history."""
    if cache is None or read_history or _sp_cache_active(cfg, mesh):
        return None
    if _declayer_ok(cfg, blocks, x, cache):
        return "declayer"
    if _boundary_ok(cfg, blocks, x):
        return "boundary"
    return None


def _run_decode_fused_layers(cfg: GPTJConfig, blocks: Dict, x: torch.Tensor, positions,
                             cache: Dict, cache_index):
    """A b=1 s=1 decode step with all layers in one launch
    (``gptj.py:981-1043``): layer 0's ln_1 and in_proj (K3 or K2b), then
    ``decode_all_layers_fused`` (K8; its plain version on the CPU) for the
    rotary, the cache attention, the gelu, the dual, the adapters, the
    residual and the next LN and in_proj of every layer.  ``positions`` and
    ``cache_index`` stay on the device.  Returns (x (1, 1, D), new keys,
    new values (L, 1, 1, h, hd)); the caller writes the cache."""
    from magma_tpu_torch.ops.decode_layer import decode_all_layers_fused

    L, D = cfg.n_layers, cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim
    cdt = cfg.compute_dtype
    scale = (1.0 / hd ** 0.5) if cfg.scale_attn else 1.0
    attn_w, bv = blocks["attn"], blocks["bvecs"]
    fc_in_b = blocks["mlp"]["fc_in"]["bias"].float()
    dev = x.device
    pos = torch.as_tensor(positions, device=dev).reshape(-1)[:1]
    sincos = rotary_sincos(pos, cfg.rotary_dim)  # each (1, rotary_dim / 2)
    idx = torch.as_tensor(cache_index, device=dev).reshape(-1)[:1].to(torch.int32)
    kvs = (cache["k_scale"], cache["v_scale"]) if "k_scale" in cache else None
    bf = torch.bfloat16
    x2 = x.reshape(1, D)
    u2 = _layer_norm(x2, {"scale": blocks["ln_1"]["scale"][0],
                          "bias": blocks["ln_1"]["bias"][0]}, cfg.ln_eps, cdt)
    fused = _mm(u2, {**attn_w["in_proj"], "idx": 0}, cdt)
    y, k_new, v_new = decode_all_layers_fused(
        fused.to(bf), x2.to(bf), u2.to(bf), sincos, cache["k"], cache["v"], kvs, idx,
        attn_w["out_proj"], attn_w["in_proj"], fc_in_b, bv["b_fc_out"], bv["ln_g"],
        bv["ln_b"], n_heads=h, o_bias=bv.get("o_bias"), scale=scale, ln_eps=cfg.ln_eps,
        **_fused_adapter_kwargs(cfg, blocks))
    return (y.reshape(1, 1, D).to(cdt), k_new.reshape(L, 1, 1, h, hd).to(cdt),
            v_new.reshape(L, 1, 1, h, hd).to(cdt))


def _run_decode_boundary(cfg: GPTJConfig, blocks: Dict, x: torch.Tensor, sin, cos,
                         cache: Dict, cache_index):
    """A decode step over boundary launches (``gptj.py:1046-1115``): layer
    0's ln_1 and in_proj (K3), then per layer the rotary, the cache
    attention and the gelu in torch and one ``boundary_fused_stacked`` (K6)
    for the dual, the adapters, the residual, the next LN and the next
    in_proj.  Returns (x, new keys, new values (L, b, 1, h, hd)), the
    caller writes the cache."""
    from magma_tpu_torch.ops.quant import boundary_fused_stacked, int4_matmul_stacked

    L, D = cfg.n_layers, cfg.d_model
    b = x.shape[0]
    cdt = cfg.compute_dtype
    h, hd = cfg.n_heads, cfg.head_dim
    scale = (1.0 / hd ** 0.5) if cfg.scale_attn else 1.0
    attn_w, bv = blocks["attn"], blocks["bvecs"]
    fc_in_b = blocks["mlp"]["fc_in"]["bias"]
    adapters = _fused_adapter_kwargs(cfg, blocks)
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
                                self_kv=(kk, v), kv_scales=_layer_scales(cache, l)).reshape(b, D)
        mh2 = F.gelu(fused[:, 3 * D:] + fc_in_b[l].to(cdt), approximate="tanh")
        outs = boundary_fused_stacked(
            ctx2, mh2, x2, attn_w["out_proj"], bv["b_fc_out"], bv["ln_g"], bv["ln_b"], l,
            w_in=None if l == L - 1 else attn_w["in_proj"], u_in=u2, o_bias=bv.get("o_bias"),
            ln_eps=cfg.ln_eps, **adapters)
        if l == L - 1:
            x2, u2 = outs  # u2 is ln_f(x2); forward applies ln_f itself
        else:
            x2, u2, fused = outs
    return x2.reshape(b, 1, D).to(cdt), torch.stack(k_news), torch.stack(v_news)


def _write_cache(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 cache_index, sp: Optional[Tuple[int, int]] = None) -> Dict:
    """Write all layers' new K/V, (L, b, s, h, hd), into the cache at
    ``cache_index`` (an int, a scalar tensor, or per-row (b,)).  Each row's
    start clamps into ``[0, max_len - s]``, as ``dynamic_update_slice``
    clamps it in the JAX package (``gptj.py:809-853``): a write at
    ``max_len`` lands at ``max_len - s``.  An int8 cache quantizes the
    entries here, its only write point, and writes the scales on their
    position axis 3.  Updates the cache in place (the JAX package returns a
    new one) and returns it.  ``sp = (rank index, ranks)`` marks this
    rank's shard of a position-sharded cache (``_write_cache_sp``)."""
    b, s = k_new.shape[1:3]
    max_len = cache["k"].shape[2]
    if "k_scale" in cache:
        entries = {}
        for name, new in (("k", k_new), ("v", v_new)):
            entries[name], entries[f"{name}_scale"] = _quantize_kv(new)
    else:
        entries = {"k": k_new.to(cache["k"].dtype), "v": v_new.to(cache["v"].dtype)}
    if sp is not None:
        return _write_cache_sp(cache, entries, cache_index, *sp)
    if isinstance(cache_index, numbers.Integral):
        # a host index: plain slices, no index tensor copied to the card
        st = min(max(int(cache_index), 0), max_len - s)
        for name, new in entries.items():
            if name.endswith("_scale"):
                cache[name][..., st:st + s] = new
            else:
                cache[name][:, :, st:st + s] = new
        return cache
    dev = cache["k"].device
    start = torch.as_tensor(cache_index, device=dev).to(torch.long).reshape(-1, 1)
    pos = (start.clamp(0, max_len - s) + torch.arange(s, device=dev)).expand(b, s)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    for name, new in entries.items():
        if name.endswith("_scale"):
            # a position-major view of the (L, b, h, max_len) scales
            cache[name].transpose(-1, -2)[:, rows, pos] = new.transpose(-1, -2)
        else:
            cache[name][:, rows, pos] = new
    return cache


def _write_cache_sp(cache: Dict, entries: Dict, cache_index, idx: int, n: int) -> Dict:
    """The write of ``_write_cache`` into rank ``idx``'s shard of a cache
    whose position axis is split over n ranks: each row's start clamps into
    ``[0, n s_loc - s]`` on the global axis first, then only the positions
    this rank owns, ``[idx s_loc, (idx + 1) s_loc)``, are written."""
    b, s = entries["k"].shape[1:3]
    s_loc = cache["k"].shape[2]
    off = idx * s_loc
    if isinstance(cache_index, numbers.Integral):
        st = min(max(int(cache_index), 0), n * s_loc - s)
        lo, hi = max(st, off), min(st + s, off + s_loc)
        if lo < hi:
            for name, new in entries.items():
                src = new[..., lo - st:hi - st] if name.endswith("_scale") else \
                    new[:, :, lo - st:hi - st]
                if name.endswith("_scale"):
                    cache[name][..., lo - off:hi - off] = src
                else:
                    cache[name][:, :, lo - off:hi - off] = src
        return cache
    if s != 1:
        raise ValueError("a per-row write into the sequence-sharded cache takes one "
                         "position (a decode step)")
    dev = cache["k"].device
    start = torch.as_tensor(cache_index, device=dev).to(torch.long).reshape(-1).expand(b)
    local = start.clamp(0, n * s_loc - 1) - off
    owned = (local >= 0) & (local < s_loc)
    pos = local.clamp(0, s_loc - 1)
    rows = torch.arange(b, device=dev)
    for name, new in entries.items():
        # a row this rank does not own writes its own value back
        if name.endswith("_scale"):
            view = cache[name].transpose(-1, -2)          # (L, b, max_len, h)
            old = view[:, rows, pos]
            view[:, rows, pos] = torch.where(owned[None, :, None], new[..., 0], old)
        else:
            old = cache[name][:, rows, pos]
            keep = owned.reshape(1, b, *([1] * (old.dim() - 2)))
            cache[name][:, rows, pos] = torch.where(keep, new[:, :, 0], old)
    return cache


def _layer_scales(cache: Dict, layer: int):
    """The layer's (k_scale, v_scale), each (b, h, max_len), of an int8
    cache; None for a bf16 one."""
    if "k_scale" not in cache:
        return None
    return cache["k_scale"][layer], cache["v_scale"][layer]


def forward(
    cfg: GPTJConfig,
    params: Dict,
    inputs_embeds: torch.Tensor,      # (b, s, D)
    *,
    positions: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
    cache_index=None,
    remat: Optional[bool] = None,
    return_hidden: bool = False,
    read_history: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """LM forward from embeddings.  Returns (fp32 logits, cache), or
    (hidden after ln_f, cache) with ``return_hidden=True`` (the chunked
    training loss's input: the full logits never exist).  ``cache`` is
    updated in place.  Without a cache, ``remat`` (default ``cfg.remat``)
    runs each layer under ``torch.utils.checkpoint(use_reentrant=False)``
    when autograd records: the backward recomputes the layer (its K1 and
    int8 products launch again) instead of keeping its activations.
    ``read_history`` (with a cache): a chunk of s > 1 positions attends to
    the history ``[0, cache_index)`` as well as causally to itself, and the
    fused decode paths stand down, as in the JAX package
    (``gptj.py:1207, 1220``).

    ``mesh`` (``parallel/``): ``params`` are this rank's shards and the
    collectives run over the mesh's axes (module docstring).  With
    ``attention_impl="ring"`` and no cache, ``inputs_embeds`` is this
    rank's shard of the sequence, which starts (default ``positions``) at
    ``axis_index(sp_axis) * s``, and so are the hidden states returned."""
    b, s, _ = inputs_embeds.shape
    cdt = cfg.compute_dtype
    x = inputs_embeds.to(cdt)
    dev = x.device
    if positions is None:  # no host scalar is copied to the card
        start = 0 if cache_index is None else cache_index
        if cache is None and cfg.attention_impl == "ring" and mesh is not None:
            start = mesh.axis_index(cfg.sp_axis) * s
        if isinstance(start, numbers.Integral):
            positions = torch.arange(int(start), int(start) + s, device=dev).expand(b, s)
        else:
            positions = (torch.as_tensor(start, device=dev).reshape(-1, 1)
                         + torch.arange(s, device=dev)).expand(b, s)
    sin, cos = rotary_sincos(positions, cfg.rotary_dim)

    blocks = params["blocks"]
    sp_cache = _sp_cache_active(cfg, mesh)
    fused = fused_decode(cfg, blocks, x, cache, mesh, read_history)
    if fused == "declayer":
        x, k_news, v_news = _run_decode_fused_layers(cfg, blocks, x, positions, cache,
                                                     cache_index)
    elif fused == "boundary":
        x, k_news, v_news = _run_decode_boundary(cfg, blocks, x, sin, cos, cache, cache_index)
    elif cache is None and (cfg.remat if remat is None else remat) and torch.is_grad_enabled():
        for bp in _layer_views(blocks, cfg.n_layers):
            x = checkpoint(_block_no_cache, cfg, bp, x, sin, cos, kv_len, mesh,
                           use_reentrant=False)
    else:
        k_news, v_news = [], []
        for i, bp in enumerate(_layer_views(blocks, cfg.n_layers)):
            x, new_kv = _block(cfg, bp, x, sin, cos, kv_len,
                               None if cache is None else (cache, i), cache_index,
                               read_history, mesh)
            if new_kv is not None:
                k_news.append(new_kv[0])
                v_news.append(new_kv[1])
        if cache is not None:
            k_news, v_news = torch.stack(k_news), torch.stack(v_news)
    if cache is not None:
        sp = (mesh.axis_index(cfg.sp_axis), mesh.size(cfg.sp_axis)) if sp_cache else None
        cache = _write_cache(cache, k_news, v_news, cache_index, sp)

    x = _layer_norm(x, params["ln_f"], cfg.ln_eps, cdt)
    if return_hidden:
        return x, cache
    return lm_head(cfg, params, x, mesh), cache


def _block_no_cache(cfg, bp, x, sin, cos, kv_len, mesh=None):
    return _block(cfg, bp, x, sin, cos, kv_len, None, None, mesh=mesh)[0]


class _HeadF32(torch.autograd.Function):
    """bf16 hidden (M, D) @ bf16 wte (V, D)^T accumulated and returned in
    fp32 on the card (``preferred_element_type=float32``); the input
    gradient likewise, from the fp32 output gradient rounded to bf16.  No
    gradient for wte, the frozen embedding."""

    @staticmethod
    def forward(ctx, flat, w):
        ctx.save_for_backward(w)
        return torch.mm(flat, w.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return torch.mm(g.to(w.dtype), w, out_dtype=torch.float32).to(w.dtype), None


def _head_local(params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    if "lm_head_q" in params:
        return _mm(hidden, params["lm_head_q"], torch.float32)
    w = params["wte"].to(hidden.dtype)
    if hidden.dtype == torch.float32:
        return hidden @ w.T
    if hidden.is_cuda:
        flat = hidden.reshape(-1, hidden.shape[-1])
        out = _HeadF32.apply(flat, w)
        return out.reshape(*hidden.shape[:-1], w.shape[0])
    return hidden.float() @ w.float().T


def lm_head(cfg: GPTJConfig, params: Dict, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """Hidden states -> fp32 logits: the int8 head ``lm_head_q`` (K2a,
    differentiable through K10) when ``quantize_lm_params`` made one, else
    the tied (padded) ``wte``, the product accumulated in fp32 and returned
    unrounded, as ``preferred_element_type=float32`` gives it in the JAX
    package.  Under tp the rank's vocab shard (the int8 shard's zero
    padding cut off) is gathered over "tp" into the full padded vocab."""
    from magma_tpu_torch.parallel.mesh import copy_to, gather_from

    tp = 1 if mesh is None else mesh.size("tp")
    if tp == 1:
        return _head_local(params, hidden)
    local = _head_local(params, copy_to(hidden, mesh, "tp"))
    return gather_from(local[..., :cfg.padded_vocab_size // tp], mesh, "tp")


def embed_tokens(cfg: GPTJConfig, params: Dict, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Token ids -> word embeddings in the compute dtype.  Under tp each
    rank looks up the ids of its vocab shard, zeros elsewhere, and the
    shards are summed over "tp" (exact: one term is non-zero)."""
    from magma_tpu_torch.parallel.mesh import reduce_from

    if mesh is None or mesh.size("tp") == 1:
        return F.embedding(ids, params["wte"]).to(cfg.compute_dtype)
    wte = params["wte"]
    lo = mesh.axis_index("tp") * wte.shape[0]
    local = ids - lo
    mine = (local >= 0) & (local < wte.shape[0])
    emb = F.embedding(torch.where(mine, local, 0), wte) * mine[..., None].to(wte.dtype)
    return reduce_from(emb, mesh, "tp").to(cfg.compute_dtype)


def logits_mask(cfg: GPTJConfig, device=None) -> torch.Tensor:
    """Boolean (padded_vocab,) -- True for real vocab entries."""
    return torch.arange(cfg.padded_vocab_size, device=device) < cfg.vocab_size
