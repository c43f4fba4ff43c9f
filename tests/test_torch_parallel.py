"""The port's parallelism (``magma_tpu_torch.parallel`` and the layers that
take a mesh) against the JAX package's, on the CPU.

The JAX side runs in this process on conftest's 8 virtual CPU devices;
the port's runs in 4 gloo processes (``torch_parallel_worker.spawn``),
which never import jax.  Inputs are numpy-seeded; weights come from the
JAX ``init_params`` and reach the port through ``convert.from_jax_params``.

* Mesh and sharding, in this process: the rank layouts of (2, 4),
  (2, 2, 2) and (1, 2, 4) equal JAX's device layouts; every path's spec of
  a tiny LM's bf16 tree and its int8 trees (``fuse_in_proj`` True and
  False) equals JAX's; each rank's shard equals JAX's addressable shard
  on that device, bit for bit (the int8 head's shard beyond its zero
  padding); partition and combine round-trip.
* Ring attention at sp 4, causal and not, fp32: outputs within 2e-4 and
  q/k/v gradients within 2e-3 of JAX's (the JAX test's bounds: both sum
  the ring's blocks in fp32 in another order).
* ``sp_decode_attention`` at sp 4, cur_len 0, ragged and full: over a
  bf16 cache the weights round to bf16 in both (``wdt``), so an output on
  a rounding boundary may land one bf16 ulp apart: 2^-7 of the largest
  output; over an int8 cache (fp32 weights) 1e-5.
* ``generate_tokens(mesh=)`` over the position-sharded cache at sp 4:
  greedy tokens identical to JAX's sp generate (bf16 and int8 caches,
  ragged ``prompt_len``).
* Tensor parallelism at tp 2 and 4: the forward's logits against JAX's
  forward over the tp-sharded params (fp32: 1e-4; the int8
  ``fuse_in_proj=False`` layout 2e-3, the int8 products' fp32 roundings,
  ``test_torch_quant_lm``), greedy tokens identical; the engine at tp 2
  gives JAX's tokens, and tp 3 with 4 heads raises ValueError.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from magma_tpu.models import gptj as jgptj
from magma_tpu.models.adapters import AdapterSpec as JAdapterSpec
from magma_tpu.ops.sampling import generate_tokens as jgenerate
from magma_tpu.parallel import sharding as jsharding
from magma_tpu.parallel.mesh import make_mesh as jmake_mesh
from magma_tpu.parallel.partition import partition as jpartition
from magma_tpu.parallel.ring_attention import context_parallel_attention as jring
from magma_tpu.parallel.sp_decode import sp_decode_attention as jsp_decode
from magma_tpu.serving import LMServingEngine as JEngine
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec
from magma_tpu_torch.parallel import combine, partition, sharding
from magma_tpu_torch.parallel.mesh import Mesh, mesh_layout
from magma_tpu_torch.serving import LMServingEngine as TEngine
from magma_tpu_torch.utils import init_distributed, tree_items, tree_map, tree_paths
from torch_parallel_worker import spawn

WORLD = 4
ADAPTER = dict(adapter_type="normal", downsample_factor=4)


def _lm(seed=0, **kw):
    """The tiny GPT-J (4 heads of 32, fp32) with a perturbed mlp adapter:
    (JAX config, port config, numpy params)."""
    jcfg = jgptj.GPTJConfig.tiny(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                                 mlp_adapter=JAdapterSpec(**ADAPTER), **kw)
    tcfg = tgptj.GPTJConfig.tiny(compute_dtype=torch.float32, param_dtype=torch.float32,
                                 mlp_adapter=TAdapterSpec(**ADAPTER), **kw)
    p = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(seed), jcfg))
    r = np.random.default_rng(seed)
    p["blocks"]["adapter_mlp"] = jax.tree_util.tree_map(
        lambda a: (a + r.standard_normal(a.shape) * 0.05).astype(np.float32),
        p["blocks"]["adapter_mlp"])
    return jcfg, tcfg, p


def _cfg_kw(tcfg):
    """A port GPTJConfig as picklable keywords (dtypes by name)."""
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    for k, v in kw.items():
        if isinstance(v, torch.dtype):
            kw[k] = str(v).split(".")[-1]
    return kw


def _jtree_paths(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# In this process: layouts, specs, shards, partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,tp,sp", [(2, 4, 1), (2, 2, 2), (1, 2, 4)])
def test_mesh_layout_matches_jax(dp, tp, sp):
    jmesh = jmake_mesh(dp, tp, sp)
    want = np.vectorize(lambda d: d.id)(jmesh.devices)
    got = mesh_layout(8, dp, tp, sp)
    np.testing.assert_array_equal(got, want)
    assert got.shape == tuple(jmesh.shape.values())
    with pytest.raises(ValueError, match="divisible"):
        mesh_layout(8, -1, 3)
    with pytest.raises(ValueError, match="!= ranks"):
        mesh_layout(8, 3, 2)


def _fake_mesh(dp, tp, sp, rank):
    """This process as rank ``rank`` of a layout, without groups: enough for
    specs and slices, which need no collective."""
    layout = mesh_layout(dp * tp * sp, dp, tp, sp)
    names = ("dp", "tp") if layout.ndim == 2 else ("dp", "tp", "sp")
    return Mesh(layout, names, rank, range(layout.size), {})


def _trees():
    """{layout: (JAX LM tree, port LM tree)}: bf16 and both int8 layouts."""
    jcfg, tcfg, p = _lm()
    out = {}
    for name in ("bf16", "int8_fused", "int8_tp"):
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        tp = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
        if name != "bf16":
            fuse = name == "int8_fused"
            jp = jgptj.quantize_lm_params(jp, fuse_in_proj=fuse)
            tp = tgptj.quantize_lm_params(tp, fuse_in_proj=fuse)
        out[name] = (jp, tp)
    return out


@pytest.fixture(scope="module")
def trees():
    return _trees()


def test_lm_param_specs_match_jax(trees):
    for name, (jp, tp) in trees.items():
        jpaths = _jtree_paths(jp)
        tpaths = dict(tree_items(tp))
        assert sorted(jpaths) == sorted(tpaths), name
        for path, leaf in jpaths.items():
            want = tuple(jsharding.lm_param_spec("lm/" + path, leaf.ndim))
            got = sharding.lm_param_spec("lm/" + path, leaf.ndim)
            assert got == want, (name, path, got, want)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4)])
def test_each_rank_shard_is_jax_addressable_shard(trees, shape):
    """The bf16 and the tensor-parallel int8 trees on 8 ranks: rank r's
    slice of every leaf is the data JAX places on device r."""
    jmesh = jmake_mesh(*shape)
    for name in ("bf16", "int8_tp"):
        jp, tp = trees[name]
        placed = _jtree_paths(jsharding.shard_lm_params(jmesh, jp))
        for r in range(8):
            mesh = _fake_mesh(*shape, r)
            mine = dict(tree_items(sharding.shard_lm_params(mesh, tp)))
            for path, arr in placed.items():
                want = next(np.asarray(s.data) for s in arr.addressable_shards
                            if s.device.id == r)
                got = mine[path]
                got = (got.float() if got.dtype == torch.bfloat16 else got).numpy()
                want = want.astype(got.dtype)
                if path.startswith("lm_head_q"):  # padded to 128 columns
                    pad = got[..., want.shape[-1]:]
                    assert pad.shape[-1] == (-want.shape[-1]) % 128 and not pad.any()
                    got = got[..., :want.shape[-1]]
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {path} rank {r}")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_kv_cache_shards_match_jax(kv):
    """Head-sharded pools (the engine's under tp): each rank's shard of a
    cache equals JAX's on that device, and ``init_kv_cache(mesh=)``
    allocates exactly that shard."""
    jcfg = jgptj.GPTJConfig.tiny(kv_cache_dtype=kv)
    tcfg = tgptj.GPTJConfig.tiny(kv_cache_dtype=kv)
    r = np.random.default_rng(3)
    cache = {k: np.asarray(r.standard_normal(v.shape) * 10).astype(np.asarray(v).dtype)
             for k, v in jgptj.init_kv_cache(jcfg, 2, 64).items()}
    placed = jsharding.shard_kv_cache(jmake_mesh(1, 4, devices=jax.devices()[:4]),
                                      {k: jnp.asarray(v) for k, v in cache.items()})
    for rank in range(4):
        mesh = _fake_mesh(1, 4, 1, rank)
        mine = sharding.shard_kv_cache(mesh, {k: (torch.from_numpy(v) if v.dtype == np.int8 else
                                                  torch.from_numpy(v.astype(np.float32))
                                                  .bfloat16()) for k, v in cache.items()})
        local = tgptj.init_kv_cache(tcfg, 2, 64, mesh=mesh)
        for name, arr in placed.items():
            want = next(np.asarray(s.data) for s in arr.addressable_shards
                        if s.device.id == rank)
            got = mine[name]
            got = (got.float() if got.dtype == torch.bfloat16 else got).numpy()
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
            assert local[name].shape == mine[name].shape and local[name].dtype == mine[name].dtype


def test_partition_combine_round_trip(trees):
    _, tp = trees["bf16"]
    params = {"lm": tp}
    mask = tree_map(lambda path: "adapter" in path, tree_paths(params))
    trainable, frozen = partition(params, mask)
    jt, jf = jpartition(_jtree_paths(params), _jtree_paths(mask))
    for path, t in tree_items(params):
        a, b = dict(tree_items(trainable))[path], dict(tree_items(frozen))[path]
        assert (a is t and b is None) if "adapter" in path else (a is None and b is t)
        assert (jt[path] is None) == (a is None)
    back = combine(trainable, frozen)
    assert all(t is dict(tree_items(params))[p] for p, t in tree_items(back))


def test_engine_rejects_unsplittable_heads():
    _, tcfg, p = _lm()
    params = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
    with pytest.raises(ValueError, match="n_heads"):
        TEngine(tcfg, params, device="cpu", mesh=_fake_mesh(1, 3, 1, 0))  # 4 heads, tp 3


def test_init_distributed_environment(monkeypatch):
    """Without torchrun's environment: one process; half of it: an error."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed("cpu") == (0, 0, 1)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        init_distributed("cpu")


# ---------------------------------------------------------------------------
# Across 4 gloo processes
# ---------------------------------------------------------------------------


def _ring_inputs():
    r = np.random.default_rng(0)
    mk = lambda *s: (r.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    out = {}
    for name, causal, (b, s, h, hd) in (("causal", True, (2, 64, 2, 32)),
                                        ("noncausal", False, (2, 64, 2, 32)),
                                        ("causal_grad", True, (1, 32, 2, 16))):
        out[name] = (mk(b, s, h, hd), mk(b, s, h, hd), mk(b, s, h, hd), causal,
                     float(1.0 / np.sqrt(hd)))
    return out


def _sp_decode_inputs():
    r = np.random.default_rng(1)
    b, max_len, h, hd = 2, 64, 2, 32
    mk = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    out = {}
    for dtype in ("bf16", "int8"):
        for cur_name, cur in (("zero", np.array(0, np.int32)),
                              ("ragged", np.array([13, 42], np.int32)),
                              ("full", np.array(max_len, np.int32))):
            q, k, v = mk(b, 1, h, hd), mk(b, max_len, h, hd), mk(b, max_len, h, hd)
            ks, vs = mk(b, 1, h, hd), mk(b, 1, h, hd)
            scales = None
            if dtype == "int8":
                k = np.clip(np.round(k * 20), -127, 127).astype(np.int8)
                v = np.clip(np.round(v * 20), -127, 127).astype(np.int8)
                scales = tuple(r.uniform(0.5, 2.0, (b, h, max_len)).astype(np.float32)
                               for _ in range(2))
            else:  # values a bf16 cache holds
                k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (k, v))
            out[f"{dtype}_{cur_name}"] = (q, k, v, cur, ks, vs, scales)
    return out


_TINY_SP = dict(n_layers=2, n_heads=2, d_model=64, d_ff=128, rotary_dim=16, vocab_size=256,
                max_seq_len=128, remat=False)


def _sp_gen_inputs():
    out = {}
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 9, 64), jnp.float32) * 0.1)
    for name, kv, pl in (("bf16", "bf16", None), ("int8", "int8", None),
                         ("ragged", "bf16", np.array([9, 5], np.int32))):
        tcfg = tgptj.GPTJConfig(attention_impl="ring", kv_cache_dtype=kv,
                                compute_dtype=torch.float32, param_dtype=torch.float32,
                                **_TINY_SP)
        jcfg = jgptj.GPTJConfig(attention_impl="xla", kv_cache_dtype=kv,
                                compute_dtype=jnp.float32, param_dtype=jnp.float32, **_TINY_SP)
        p = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(0), jcfg))
        out[name] = (_cfg_kw(tcfg), p, emb, pl)
    return out


def _tp_inputs():
    _, tcfg, p = _lm()
    r = np.random.default_rng(2)
    emb = (r.standard_normal((2, 12, tcfg.d_model)) * 0.5).astype(np.float32)
    return _cfg_kw(tcfg), p, emb, np.array([12, 7], np.int32)


def _engine_inputs():
    _, tcfg, p = _lm()
    prompts = [(np.random.default_rng(i).standard_normal((s, tcfg.d_model)) * 0.02)
               .astype(np.float32) for i, s in ((1, 5), (2, 11), (3, 8))]
    return _cfg_kw(tcfg), p, prompts


@pytest.fixture(scope="module")
def port():
    r = np.random.default_rng(5)
    gather = (np.array([[2, 0, 3, 1]]), r.standard_normal((2, 3, 8)).astype(np.float32),
              r.standard_normal((2, 3, 8)).astype(np.float32))
    inputs = {"ring": _ring_inputs(), "sp_decode": _sp_decode_inputs(),
              "sp_generate": _sp_gen_inputs(), "tp": _tp_inputs(), "engine": _engine_inputs(),
              "gather": gather}
    outs = spawn(["gather", "ring", "sp_decode", "sp_generate", "tp", "engine"], inputs, WORLD)
    return inputs, outs


def test_gather_follows_the_line_order(port):
    """The tp line [2, 0, 3, 1] is not the group's rank order: every rank
    gathers the whole tensor in line order (exactly), and keeps its own
    slice of the gradient."""
    inputs, outs = port
    _, full, weights = inputs["gather"]
    assert sorted(o["gather"]["index"] for o in outs) == [0, 1, 2, 3]
    for o in outs:
        np.testing.assert_array_equal(o["gather"]["gathered"], full)
        i = o["gather"]["index"]
        np.testing.assert_array_equal(o["gather"]["grad"], weights[..., 2 * i:2 * i + 2])


def test_ring_attention_matches_jax(port):
    inputs, outs = port
    mesh = JMesh(np.array(jax.devices()[:WORLD]), ("sp",))
    for name, (q, k, v, causal, scale) in inputs["ring"].items():
        def loss(q, k, v):
            o = jring(q, k, v, mesh, scale=scale, causal=causal, seq_axis="sp")
            return jnp.sum(o ** 2), o

        (_, ref), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                     has_aux=True))(q, k, v)
        got = [np.concatenate([o["ring"][name][i] for o in outs], axis=1) for i in range(4)]
        np.testing.assert_allclose(got[0], np.asarray(ref), atol=2e-4, err_msg=name)
        for g, want in zip(got[1:], grads):
            np.testing.assert_allclose(g, np.asarray(want), atol=2e-3, err_msg=name)


def test_sp_decode_attention_matches_jax(port):
    inputs, outs = port
    mesh = JMesh(np.array(jax.devices()[:WORLD]), ("sp",))
    for name, (q, k, v, cur, ks, vs, scales) in inputs["sp_decode"].items():
        if scales is None:
            k, v = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        ref = np.asarray(jax.jit(lambda *a: jsp_decode(*a[:4], a[4:6], mesh, "sp", scale=0.17,
                                                       kv_scales=a[6:] or None))(
            q, k, v, cur, ks, vs, *(scales or ())), np.float32)
        tol = 1e-5 if scales is not None else 2.0 ** -7 * np.abs(ref).max()
        for o in outs:  # the same on every rank
            np.testing.assert_allclose(o["sp_decode"][name], ref, atol=tol, err_msg=name)


def test_sp_generate_token_identical_to_jax(port):
    inputs, outs = port
    mesh = JMesh(np.array(jax.devices()[:WORLD]), ("sp",))
    for name, (cfg_kw, p, emb, pl) in inputs["sp_generate"].items():
        jcfg = jgptj.GPTJConfig(attention_impl="ring", kv_cache_dtype=cfg_kw["kv_cache_dtype"],
                                compute_dtype=jnp.float32, param_dtype=jnp.float32, **_TINY_SP)
        toks, steps = jgenerate(jcfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(emb),
                                jax.random.PRNGKey(2), max_steps=12, temperature=0.0, top_k=0,
                                top_p=0.0, eos_token=-1, mesh=mesh,
                                prompt_len=None if pl is None else jnp.asarray(pl))
        for o in outs:
            got, got_steps = o["sp_generate"][name]
            assert got_steps == int(steps), name
            np.testing.assert_array_equal(got, np.asarray(toks), err_msg=name)


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_forward_matches_jax(port, tp):
    inputs, outs = port
    cfg_kw, p, emb, kv_len = inputs["tp"]
    jcfg, _, _ = _lm()
    jmesh = jmake_mesh(1, tp, devices=jax.devices()[:tp])
    for layout, atol in (("bf16", 1e-4), ("int8", 2e-3)):
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        if layout == "int8":
            jp = jgptj.quantize_lm_params(jp, fuse_in_proj=False)
        jp = jsharding.shard_lm_params(jmesh, jp)
        ref, _ = jgptj.forward(jcfg, jp, jnp.asarray(emb), kv_len=jnp.asarray(kv_len))
        toks, _ = jgenerate(jcfg, jp, jnp.asarray(emb), jax.random.PRNGKey(0), max_steps=8,
                            temperature=0.0, top_k=0, top_p=0.0, eos_token=-1,
                            prompt_len=jnp.asarray(kv_len))
        for o in outs:
            logits, got_toks, q_shape = o["tp"][(tp, layout)]
            assert q_shape[-1] == jcfg.d_model // tp  # the rank's heads only
            assert logits.shape == (2, 12, jcfg.padded_vocab_size)
            np.testing.assert_allclose(logits, np.asarray(ref), atol=atol, err_msg=layout)
            np.testing.assert_array_equal(got_toks, np.asarray(toks), err_msg=layout)


def test_engine_tensor_parallel_matches_jax(port):
    inputs, outs = port
    cfg_kw, p, prompts = inputs["engine"]
    jcfg, _, _ = _lm()
    jmesh = JMesh(np.array(jax.devices()[:2]), axis_names=("tp",))
    eng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, p), max_batch=4, max_len=128,
                  eos_token=50256, prefill_bucket=8, decode_window=3, mesh=jmesh)
    ids = [eng.submit(jnp.asarray(x), max_new_tokens=10) for x in prompts]
    res = eng.run()
    for o in outs:
        assert o["engine"]["tokens"] == [res[r].tokens for r in ids]
        assert o["engine"]["reasons"] == [res[r].finish_reason for r in ids]
        assert o["engine"]["pool_heads"] == jcfg.n_heads // 2
