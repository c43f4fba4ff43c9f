"""GPT-J decoder in functional PyTorch over layer-stacked parameters.

Port of the bf16 (unquantized) paths of ``magma_tpu/models/gptj.py``: the
reference LM (GPT-J 6B: 28 layers, 16 heads, hidden 4096, rotary dim 64,
vocab 50258 padded to 50304) with the parallel attention + FFN block off
one layernorm, the out-proj bias and tied input/output embeddings.

Parameters keep the JAX package's pytree: a dict whose block tensors are
stacked on a leading layer axis, (L, in, out) for projections.  Layer ``i``
is a view ``w[i]``, so the JAX package's scan and closure-constant
machinery has no counterpart here: the layer loop is a Python loop.

Numerics matched: fp32 layernorm statistics, tanh gelu, the tied head with
fp32 output over ``wte`` whose vocab-padding rows are zero, a bf16 KV cache
(L, b, max_len, h, hd) written once per forward after all layers.
Training (remat), ring/sp attention, the int8 cache and the quantized and
fused decode layouts are not ported.
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
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p: Dict, eps: float, out_dtype) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(out_dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """x @ w in cdt, promoted as ``jnp.dot`` promotes (a bf16 decode
    attention output meets fp32 weights as fp32)."""
    dt = torch.promote_types(x.dtype, cdt)
    return x.to(dt) @ w.to(dt)


def _layer_views(blocks: Dict, n_layers: int) -> List[Dict]:
    """Layer-stacked tree -> one dict of (L-axis) views per layer."""

    def split(t):
        if isinstance(t, dict):
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

    a = _mm(attn.reshape(b, s, D), bp["attn"]["o"], cdt)
    m = _mm(u, bp["mlp"]["fc_in"]["kernel"], cdt) + bp["mlp"]["fc_in"]["bias"].to(cdt)
    m = F.gelu(m, approximate="tanh")
    m = _mm(m, bp["mlp"]["fc_out"]["kernel"], cdt)

    if "o_bias" in bp["attn"]:
        a = a + bp["attn"]["o_bias"].to(cdt)
    a = apply_adapter(bp.get("adapter_attn"), cfg.attn_adapter, u, a, cdt)
    m = m + bp["mlp"]["fc_out"]["bias"].to(cdt)
    m = apply_adapter(bp.get("adapter_mlp"), cfg.mlp_adapter, u, m, cdt)
    return x + a + m, new_kv


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

    k_news, v_news = [], []
    for i, bp in enumerate(_layer_views(params["blocks"], cfg.n_layers)):
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
    """Hidden states -> fp32 logits over the tied (padded) ``wte``: the
    product accumulates in fp32 and is returned unrounded, as
    ``preferred_element_type=float32`` gives it in the JAX package."""
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
