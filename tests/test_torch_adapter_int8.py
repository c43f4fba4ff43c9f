"""The opt-in int8 adapter mode (``gptj._serving_cast_adapters(mode="int8")``)
against the JAX package's, on the CPU.

The layout is the JAX package's own recipe for it (``tests/test_quant.py``):
``quantize_lm_params(fuse_out_proj=False)`` (in_proj fused, o and fc_out
separate int8 stacks, bf16 adapters), then the int8 cast, which packs each
bottleneck kernel whose K and N are multiples of 128 as a stacked
{"q", "s"} pack and keeps everything else in bf16.  A small GPT-J (2
layers, d_model 512, 4 heads of 128, d_ff 2048) with both adapters, fp32
compute; "lane" (hidden 128) passes the guard, "off_lane" (hidden 64)
falls back to bf16.  Weights come from the port's ``init_params``
(adapters perturbed so they matter), the same values in both packages.

* The packs are byte-identical: JAX quantizes here outside ``jit``, so the
  scales are the eager division by 127 (``quantize_int8``'s default).
* Logits: every product is fp32 in both packages, x @ (W s) in JAX and
  (x @ W) s in the port, each output within a few fp32 ulps of the sum of
  |terms|; over 2 layers and the head the prefill logits (magnitude ~2)
  agree to 1e-4 (measured 3.3e-6).
* Greedy tokens are identical over 16 steps, through ``generate_tokens``:
  the per-layer chain serves this layout (the fused decodes stand down).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.models import gptj as jgptj
from magma_tpu.models.adapters import AdapterSpec as JAdapterSpec
from magma_tpu.ops.sampling import generate_tokens as jgenerate
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec
from magma_tpu_torch.ops.sampling import generate_tokens as tgenerate
from magma_tpu_torch.utils import tree_map

LM = dict(n_layers=2, d_model=512, n_heads=4, d_ff=2048, rotary_dim=16)
PREFILL_ATOL = 1e-4
RECIPES = {
    # hidden 128: every bottleneck kernel packs; an LN adapter packs too
    "lane": (dict(adapter_type="parallel", downsample_factor=4, add_layernorm=True),
             dict(adapter_type="normal", downsample_factor=4)),
    # hidden 64: off the guard, everything bf16
    "off_lane": (dict(adapter_type="normal", downsample_factor=8),
                 dict(adapter_type="scaled_parallel", downsample_factor=8)),
}


def _configs(recipe):
    mlp, attn = RECIPES[recipe]
    kw = dict(LM, attention_impl="xla")
    jcfg = jgptj.GPTJConfig.tiny(**kw, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                                 mlp_adapter=JAdapterSpec(**mlp), attn_adapter=JAdapterSpec(**attn))
    tcfg = tgptj.GPTJConfig.tiny(**kw, compute_dtype=torch.float32, param_dtype=torch.float32,
                                 mlp_adapter=TAdapterSpec(**mlp),
                                 attn_adapter=TAdapterSpec(**attn))
    return jcfg, tcfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module", params=sorted(RECIPES))
def pair(request):
    """(recipe, jcfg, tcfg, JAX tree, the port's tree), both int8 mode.  The
    weights are the port's init (adapters moved off their near-zero init,
    which hides faults), handed to JAX as numpy (no JAX init: it compiles
    for seconds)."""
    jcfg, tcfg = _configs(request.param)
    tp = tgptj.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    g = torch.Generator().manual_seed(1)
    for key in ("adapter_mlp", "adapter_attn"):
        tp["blocks"][key] = tree_map(lambda t: t + torch.randn(t.shape, generator=g) * 0.05,
                                     tp["blocks"][key])
    if "scale" in tp["blocks"]["adapter_attn"]:
        tp["blocks"]["adapter_attn"]["scale"] = torch.tensor([1.5, -0.75])
    p = tree_map(lambda t: t.numpy().copy(), tp)
    jq = jgptj._serving_cast_adapters(jgptj.quantize_lm_params(
        jax.tree_util.tree_map(jnp.asarray, p), fuse_out_proj=False), mode="int8")
    tq = tgptj._serving_cast_adapters(tgptj.quantize_lm_params(tp, fuse_out_proj=False),
                                      mode="int8")
    return request.param, jcfg, tcfg, jq, tq


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_int8_mode_packs_are_byte_identical(pair):
    recipe, _, _, jq, tq = pair
    want, got = dict(_flat(jq)), dict(_flat(tq))
    assert got.keys() == want.keys()
    packed = [k for k in got if "adapter" in k and k.endswith("kernel/q")]
    assert len(packed) == (4 if recipe == "lane" else 0)
    for k, w in want.items():
        w = np.asarray(w)
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(_np(got[k]), w.astype(_np(got[k]).dtype), err_msg=k)
    for k, t in got.items():
        if "adapter" in k and not k.endswith("kernel/q") and not k.endswith("kernel/s"):
            assert t.dtype == torch.bfloat16, k
    assert not tgptj._adapters_fused(pair[2], tq["blocks"])  # K8 and K6 stand down


def test_int8_mode_prefill_logits_and_greedy_tokens_match_jax(pair):
    _, jcfg, tcfg, jq, tq = pair
    b, s, true_len = 2, 40, 33
    x = np.random.default_rng(1).standard_normal((b, s, 512)).astype(np.float32)
    kvl = np.full((b,), true_len, np.int32)
    # jitted: one compile instead of one a traced op
    jl, _ = jax.jit(lambda p, x, c, kv: jgptj.forward(jcfg, p, x, cache=c,
                                                       cache_index=jnp.int32(0), kv_len=kv))(
        jq, jnp.asarray(x), jgptj.init_kv_cache(jcfg, b, 64), jnp.asarray(kvl))
    tl, _ = tgptj.forward(tcfg, tq, torch.from_numpy(x), cache=tgptj.init_kv_cache(tcfg, b, 64),
                          cache_index=0, kv_len=torch.from_numpy(kvl))
    np.testing.assert_allclose(tl[:, :true_len].numpy(), np.asarray(jl)[:, :true_len],
                               atol=PREFILL_ATOL)
    x = x[:1, :24]
    ref, _ = jgenerate(jcfg, jq, jnp.asarray(x), jax.random.PRNGKey(0), max_steps=16,
                       temperature=0.0)
    got, steps = tgenerate(tcfg, tq, torch.from_numpy(x), None, max_steps=16, temperature=0.0)
    assert steps == 16
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_mode_refuses_a_fused_payload():
    _, tcfg = _configs("lane")
    p = tgptj.init_params(torch.Generator().manual_seed(0),
                          dataclasses.replace(tcfg, mlp_adapter=TAdapterSpec("normal", 4),
                                              attn_adapter=None), "cpu")
    q = tgptj.quantize_lm_params(p)
    assert "fused" in q["blocks"]["adapter_mlp"]
    with pytest.raises(ValueError, match="fused"):
        tgptj._serving_cast_adapters(q, mode="int8")
    assert tgptj._serving_cast_adapters(q, mode="fused_int8") is q  # no-op
