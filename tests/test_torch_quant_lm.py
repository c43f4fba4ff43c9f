"""The int8 serving path of the port against the JAX package's, on the CPU.

A small GPT-J whose every pack takes its kernel form on a GPU: 2 layers,
d_model 512, 4 heads of 128, d_ff 2048 (in_proj N = 3584, out_proj
Ko + Kf = 512 + 2048, head 512 x 50304), the v1 mlp adapter (normal, k=4,
so DH = 128).  Weights come from the JAX ``init_params`` (adapters
perturbed so they matter) and reach the port through
``convert.from_jax_params``; inputs are numpy-seeded.  fp32 compute in
both packages.

* ``quantize_lm_params`` packs are byte-identical.
* Logits: the int8 products differ by fp32 roundings (x @ (W s) in JAX,
  (x @ W) s in the port).  In prefill the 80 adapter rows take the same
  dequantising bf16 products in both, but they round x and h to bf16, so
  fp32 noise upstream can move an h by one bf16 ulp, which moves its row
  by 2^-8 |h| |Wu| (measured 5e-4 on logits of magnitude 2): 2e-3.  A
  decode step's adapter (m <= 64) takes K5's function in the port and
  JAX's fallback with W s rounded to bf16 (2^-9 relative per weight), so
  decode logits agree to bf16 noise (measured 3.6e-3): 1e-2.
* Greedy tokens are identical over 16 steps, directly and through the
  ``Magma`` facade.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models import gptj as jgptj
from magma_tpu.models.adapters import AdapterSpec as JAdapterSpec
from magma_tpu.models.magma import Magma as JMagma
from magma_tpu.ops.sampling import generate_tokens as jgenerate
from magma_tpu.training.torch_convert import to_torch_state_dict
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec
from magma_tpu_torch.models.magma import Magma as TMagma
from magma_tpu_torch.ops.sampling import generate_tokens as tgenerate

LM = dict(n_layers=2, d_model=512, n_heads=4, d_ff=2048, rotary_dim=16)
PREFILL_ATOL = 2e-3
DECODE_ATOL = 1e-2
ADAPTERS = {
    # the v1 recipe: every adapter fused
    "v1_normal_mlp": (dict(adapter_type="normal", downsample_factor=4), None),
    # an LN adapter keeps bf16; scaled_parallel folds its scalar into K5's pack
    "ln_mlp_scaled_attn": (dict(adapter_type="parallel", downsample_factor=4, add_layernorm=True),
                           dict(adapter_type="scaled_parallel", downsample_factor=4)),
}


def _configs(adapters="v1_normal_mlp"):
    mlp, attn = ADAPTERS[adapters]
    jcfg = jgptj.GPTJConfig.tiny(
        **LM, compute_dtype=jnp.float32, param_dtype=jnp.float32,
        mlp_adapter=JAdapterSpec(**mlp) if mlp else None,
        attn_adapter=JAdapterSpec(**attn) if attn else None)
    tcfg = tgptj.GPTJConfig.tiny(
        **LM, compute_dtype=torch.float32, param_dtype=torch.float32,
        mlp_adapter=TAdapterSpec(**mlp) if mlp else None,
        attn_adapter=TAdapterSpec(**attn) if attn else None)
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    p = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(seed), jcfg))
    r = np.random.default_rng(seed)
    for key in ("adapter_mlp", "adapter_attn"):  # near-zero init hides bugs
        if key in p["blocks"]:
            p["blocks"][key] = jax.tree_util.tree_map(
                lambda a: (a + r.standard_normal(a.shape) * 0.05).astype(np.float32),
                p["blocks"][key])
    if "scale" in p["blocks"].get("adapter_attn", {}):
        p["blocks"]["adapter_attn"]["scale"] = np.array([1.5, -0.75], np.float32)
    return p


def _quantized_pair(adapters="v1_normal_mlp"):
    """(jcfg, tcfg, JAX-quantized tree, port-quantized tree)."""
    jcfg, tcfg = _configs(adapters)
    p = _jax_params(jcfg)
    tp = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
    jq = jgptj.quantize_lm_params(jax.tree_util.tree_map(jnp.asarray, p))
    return jcfg, tcfg, jq, tgptj.quantize_lm_params(tp)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("adapters", sorted(ADAPTERS))
def test_quantize_lm_params_byte_identical(adapters):
    _, _, jq, tq = _quantized_pair(adapters)
    want, got = dict(_flat(jq)), dict(_flat(tq))
    assert got.keys() == want.keys()
    for key in ("/blocks/attn/in_proj/q", "/blocks/attn/out_proj/s", "/lm_head_q/q",
                "/blocks/bvecs/ln_g"):
        assert key in got
    for k, w in want.items():
        w = np.asarray(w)
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(_np(got[k]), w.astype(_np(got[k]).dtype), err_msg=k)
    for k in ("in_proj", "out_proj"):
        assert tq["blocks"]["attn"][k]["q"].dtype == torch.int8
    fused = [k for k in ("adapter_mlp", "adapter_attn")
             if "fused" in tq["blocks"].get(k, {})]
    assert fused == (["adapter_mlp"] if adapters == "v1_normal_mlp" else ["adapter_attn"])


def test_serving_cast_adapters_bf16_mode_matches_jax():
    """mode="bf16" (the JAX tensor-parallel and training layouts' adapter
    cast): down/up, LN and scale in bf16, byte for byte; and the opt-in
    mode="int8" of the same weights: {"q", "s"} packs of the bottleneck
    kernels and bf16 for the rest, byte for byte (the serving path of that
    mode: tests/test_torch_adapter_int8.py)."""
    jcfg, tcfg = _configs("ln_mlp_scaled_attn")
    p = _jax_params(jcfg)
    tp = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
    want = jgptj._serving_cast_adapters(jax.tree_util.tree_map(jnp.asarray, p), mode="bf16")
    got = tgptj._serving_cast_adapters(tp, mode="bf16")
    want, got = dict(_flat(want)), dict(_flat(got))
    assert got.keys() == want.keys()
    for k in (k for k in want if "adapter" in k):
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]).astype(np.float32),
                                      err_msg=k)
    want = jgptj._serving_cast_adapters(jax.tree_util.tree_map(jnp.asarray, p), mode="int8")
    got = tgptj._serving_cast_adapters(
        from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"], mode="int8")
    want, got = dict(_flat(want)), dict(_flat(got))
    assert got.keys() == want.keys()
    for k in (k for k in want if "adapter" in k):
        w = np.asarray(want[k])
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        np.testing.assert_array_equal(_np(got[k]), w.astype(_np(got[k]).dtype), err_msg=k)
    assert got["/blocks/adapter_attn/up/kernel/q"].dtype == torch.int8


def test_from_jax_params_keeps_the_int8_layout():
    """A quantized JAX tree crosses as it is stored: int8 stays int8,
    scales, biases and bvecs stay fp32, and it equals the port's own
    quantization of the same weights."""
    jcfg, tcfg, jq, tq = _quantized_pair()
    np_tree = jax.tree_util.tree_map(np.asarray, jq)
    got = from_jax_params({"lm": np_tree, "image_prefix": {}}, None,
                          dataclasses.replace(tcfg, param_dtype=torch.bfloat16), None)[0]["lm"]
    assert got["blocks"]["attn"]["in_proj"]["q"].dtype == torch.int8
    assert got["blocks"]["adapter_mlp"]["fused"]["wu"].dtype == torch.int8
    assert got["lm_head_q"]["s"].dtype == torch.float32
    assert got["blocks"]["bvecs"]["b_fc_out"].dtype == torch.float32
    assert got["wte"].dtype == torch.bfloat16  # outside the packs: param_dtype
    got = dict(_flat(got))
    for k, t in _flat(tq):
        if t.dtype == torch.int8 or "bvecs" in k or "_proj/" in k or "fused" in k:
            torch.testing.assert_close(got[k], t, atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_int8_prefill_and_cached_decode_match_jax(impl):
    """Prefill over right-padded prompts (80 rows: the adapter takes the
    dequantising path), then 4 cached decode steps (K5's function)."""
    jcfg, tcfg, jp, tp = _quantized_pair()
    tcfg = dataclasses.replace(tcfg, attention_impl=impl)
    b, s, steps, true_len, max_len = 2, 40, 4, 33, 64
    x = np.random.default_rng(1).standard_normal((b, s, 512)).astype(np.float32)
    ids = np.random.default_rng(2).integers(0, 1000, (steps, b)).astype(np.int32)
    kvl = np.full((b,), true_len, np.int32)
    jcache, tcache = jgptj.init_kv_cache(jcfg, b, max_len), tgptj.init_kv_cache(tcfg, b, max_len)
    jl, jcache = jgptj.forward(jcfg, jp, jnp.asarray(x), cache=jcache,
                               cache_index=jnp.int32(0), kv_len=jnp.asarray(kvl))
    tl, tcache = tgptj.forward(tcfg, tp, torch.from_numpy(x), cache=tcache,
                               cache_index=0, kv_len=torch.from_numpy(kvl))
    np.testing.assert_allclose(tl[:, :true_len].numpy(), np.asarray(jl)[:, :true_len],
                               atol=PREFILL_ATOL)
    for t in range(steps):
        cur = true_len + t
        jemb = jgptj.embed_tokens(jcfg, jp, jnp.asarray(ids[t][:, None]))
        temb = tgptj.embed_tokens(tcfg, tp, torch.from_numpy(ids[t][:, None]).long())
        jl, jcache = jgptj.forward(jcfg, jp, jemb, cache=jcache,
                                   cache_index=jnp.full((b,), cur, jnp.int32))
        tl, tcache = tgptj.forward(tcfg, tp, temb, cache=tcache,
                                   cache_index=torch.full((b,), cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=DECODE_ATOL,
                                   err_msg=f"decode step {t}")


def test_int8_greedy_tokens_identical_to_jax():
    jcfg, tcfg, jp, tp = _quantized_pair()
    x = np.random.default_rng(3).standard_normal((1, 24, 512)).astype(np.float32)
    ref, _ = jgenerate(jcfg, jp, jnp.asarray(x), jax.random.PRNGKey(0), max_steps=16,
                       temperature=0.0)
    got, steps = tgenerate(tcfg, tp, torch.from_numpy(x), None, max_steps=16, temperature=0.0)
    assert steps == 16
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# through the facade: JAX Magma -> reference-named .pt -> port Magma
# ---------------------------------------------------------------------------

PROMPT = "Describe the painting:"
# the folded tower runs bf16 end to end, so its encoder keeps the bf16
# compute dtype (the JAX package's lax.conv refuses fp32 x bf16)
ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)
# the folded weights are byte-identical, but the bf16 convolutions sum in
# another order (XLA vs oneDNN) and round their outputs to bf16, so values
# land a bf16 ulp apart here and there through the tower; after the
# ImagePrefix LN the embeddings reach |4|, where one bf16 ulp is 2^-6
# (measured 0.026)
EMB_ATOL = 0.05


def _mm_config_kwargs():
    return dict(
        batch_size=2, train_steps=4, encoder_name="clip_resnet_large",
        adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.1,
        lm_overrides=dict(LM, max_seq_len=128, attention_impl="flash"),
        image_size=64, compute_dtype="float32", param_dtype="float32",
        frozen_dtype="float32", attention_impl="flash", encoder_overrides=ENC)


def _image():
    arr = np.random.default_rng(7).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    return Image.fromarray(arr)


@pytest.fixture(scope="module")
def served_pair(tmp_path_factory):
    """(JAX Magma, port Magma), both after quantize_for_serving(8)."""
    cfg = JConfig(**dict(_mm_config_kwargs(), lm_overrides=dict(LM, max_seq_len=128,
                                                                attention_impl="xla"),
                         attention_impl="xla"))
    jm = JMagma(cfg, rng=0)
    r = np.random.default_rng(0)
    jm.params = jax.tree_util.tree_map(
        lambda a: a + r.standard_normal(a.shape).astype(np.float32) * 0.02, jm.params)
    jm.params["lm"]["wte"] = jm.params["lm"]["wte"].at[jm.lm_config.vocab_size:].set(0)
    jm.state = jax.tree_util.tree_map(
        lambda a: a + np.abs(r.standard_normal(a.shape)).astype(np.float32) * 0.2, jm.state)
    sd = to_torch_state_dict(jm.params, jm.state, jm.lm_config, jm.prefix_config)
    path = tmp_path_factory.mktemp("ckpt") / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    tm = TMagma.from_checkpoint(TConfig(**_mm_config_kwargs()), path, device="cpu")
    return jm.quantize_for_serving(8), tm.quantize_for_serving(8)


def test_facade_int8_serving_matches_jax(served_pair):
    jm, tm = served_pair
    assert tm.params["lm"]["blocks"]["attn"]["in_proj"]["q"].dtype == torch.int8
    assert tm.params["image_prefix"]["enc"]["stem"]["conv1"]["kernel"].dtype == torch.bfloat16
    jfold = dict(_flat(jax.tree_util.tree_map(np.asarray, jm.params["image_prefix"])))
    assert set(jfold) == set(dict(_flat(tm.params["image_prefix"])))
    jenc, tenc = jm.params["image_prefix"]["enc"], tm.params["image_prefix"]["enc"]
    for jc, tc in ((jenc["stem"]["conv1"], tenc["stem"]["conv1"]),
                   (jenc["layer3"][0]["down_conv"], tenc["layer3"][0]["down_conv"])):
        np.testing.assert_array_equal(  # HWIO -> OIHW
            tc["kernel"].float().numpy(),
            np.asarray(jc["kernel"]).astype(np.float32).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(tc["bias"].float().numpy(),
                                      np.asarray(jc["bias"]).astype(np.float32))
    ref_emb = np.asarray(jm.preprocess_inputs([_image(), PROMPT]))
    emb = tm.preprocess_inputs([_image(), PROMPT])
    assert emb.shape == ref_emb.shape
    np.testing.assert_allclose(emb.float().numpy(), ref_emb.astype(np.float32), atol=EMB_ATOL)
    # the same embeddings into both generates: tokens must be identical
    ref = jm.generate(jnp.asarray(ref_emb), max_steps=16, temperature=0.0, decode=False)
    got = tm.generate(torch.from_numpy(np.array(ref_emb, np.float32)), max_steps=16,
                      temperature=0.0, decode=False)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_facade_quantize_for_serving_bits():
    """bits=3 raises and changes nothing; bits=4 gives the int4 layout
    (q4 packs, the int8 head, bvecs, a fused adapter) and folds the tower."""
    model = TMagma(TConfig(**_mm_config_kwargs()), seed=1, device="cpu")
    with pytest.raises(ValueError, match="bits"):
        model.quantize_for_serving(3)
    assert "q" in model.params["lm"]["blocks"]["attn"]  # nothing was changed
    model.quantize_for_serving(4)
    lm = model.params["lm"]
    for k in ("in_proj", "out_proj"):
        assert set(lm["blocks"]["attn"][k]) == {"q4", "s4"}
        assert lm["blocks"]["attn"][k]["q4"].dtype == torch.int8
    assert lm["blocks"]["attn"]["in_proj"]["q4"].shape == (2, 256, 3 * 512 + 2048)
    assert lm["lm_head_q"]["q"].dtype == torch.int8 and "bvecs" in lm["blocks"]
    assert "fused" in lm["blocks"]["adapter_mlp"]
    enc = model.params["image_prefix"]["enc"]
    assert enc["stem"]["conv1"]["kernel"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="full-precision"):
        model.quantize_for_serving(4)  # int4 must start from full precision
