"""The port's continuous-batching engine against the JAX package's, on the
CPU.

The cases of ``tests/test_serving.py`` (all but its two tensor-parallel
ones) run the same requests through ``magma_tpu.serving.LMServingEngine``
and ``magma_tpu_torch.serving.LMServingEngine`` on the same weights (the
tiny GPT-J at fp32, from the JAX ``init_params`` through
``convert.from_jax_params``; prompts numpy-seeded), and hold the port's
tokens and finish reasons equal to JAX's.  Sampling is greedy or
top_k = 1: the two packages draw from different random streams.  The
int8 and int4 cases quantize the same weights in both packages (the v1
mlp adapter at a hidden width of 128, so its fused int8 form is taken).
``MagmaServingEngine`` gives JAX's strings end to end.
"""

import subprocess
import sys
from pathlib import Path

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
from magma_tpu.serving import LMServingEngine as JEngine
from magma_tpu.serving import MagmaServingEngine as JMagmaEngine
from magma_tpu.training.torch_convert import to_torch_state_dict
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec
from magma_tpu_torch.models.magma import Magma as TMagma
from magma_tpu_torch.ops.sampling import generate_tokens as tgenerate
from magma_tpu_torch.serving import FinishedRequest
from magma_tpu_torch.serving import LMServingEngine as TEngine
from magma_tpu_torch.serving import MagmaServingEngine as TMagmaEngine
from magma_tpu_torch.serving import engine as teng

ROOT = Path(__file__).resolve().parents[1]
EOS = 50256
D = 128


def _pair(recipe=None, **cfg_kw):
    """(jcfg, tcfg, JAX params, port params) of the tiny fp32 GPT-J."""
    spec = dict(adapter_type="normal", downsample_factor=1) if recipe else None
    jcfg = jgptj.GPTJConfig.tiny(compute_dtype=jnp.float32, param_dtype=jnp.float32,
                                 mlp_adapter=spec and JAdapterSpec(**spec), **cfg_kw)
    tcfg = tgptj.GPTJConfig.tiny(compute_dtype=torch.float32, param_dtype=torch.float32,
                                 mlp_adapter=spec and TAdapterSpec(**spec), **cfg_kw)
    p = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(0), jcfg))
    if recipe:  # near-zero init hides bugs
        r = np.random.default_rng(0)
        p["blocks"]["adapter_mlp"] = jax.tree_util.tree_map(
            lambda a: (a + r.standard_normal(a.shape) * 0.05).astype(np.float32),
            p["blocks"]["adapter_mlp"])
    tp = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    if recipe == "int8":
        jp, tp = jgptj.quantize_lm_params(jp), tgptj.quantize_lm_params(tp)
    elif recipe == "int4":
        jp, tp = jgptj.quantize_lm_params_int4(jp), tgptj.quantize_lm_params_int4(tp)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def lm():
    return _pair()


def _prompt(seed, s):
    return (np.random.default_rng(seed).standard_normal((s, D)) * 0.02).astype(np.float32)


def _both(lm, script, **engine_kw):
    """Run ``script`` through both engines: items ("submit", prompt,
    max_new, sampling kwargs) or ("step",), then ``run``.  Asserts the
    port's tokens and finish reasons equal JAX's, request by request, and
    returns (port engine, [port tokens by submission])."""
    jcfg, tcfg, jp, tp = lm
    out = []
    for eng in (JEngine(jcfg, jp, **engine_kw), TEngine(tcfg, tp, device="cpu", **engine_kw)):
        ids = []
        for item in script:
            if item[0] == "submit":
                _, p, n, kw = item
                ids.append(eng.submit(p, max_new_tokens=n, **kw))
            else:
                eng.step()
        res = eng.run()
        assert set(res) == set(ids)
        out.append((eng, [(res[r].tokens, res[r].finish_reason) for r in ids]))
    (_, want), (teng_, got) = out
    assert got == want
    return teng_, [t for t, _ in got]


def _submits(prompts, max_new, **kw):
    return [("submit", p, max_new, kw) for p in prompts]


def _port_reference(lm, p, max_steps, eos):
    """The port's single-request greedy ``generate_tokens``, cut after EOS."""
    _, tcfg, _, tp = lm
    toks, n = tgenerate(tcfg, tp, torch.from_numpy(p)[None], None, max_steps=max_steps,
                        temperature=0.0, eos_token=eos)
    row = toks[0, :n].tolist()
    return row[:row.index(eos) + 1] if eos in row else row


BASE = dict(max_batch=4, max_len=128, eos_token=EOS, prefill_bucket=8)


def test_engine_matches_individual_generate(lm):
    prompts = [_prompt(i, s) for i, s in ((1, 5), (2, 11), (3, 8))]
    _, got = _both(lm, _submits(prompts, 12), **BASE)
    for toks, p in zip(got, prompts):
        assert toks == _port_reference(lm, p, 12, EOS)


def test_engine_mid_stream_admission(lm):
    _both(lm, [("submit", _prompt(10, 9), 14, {}), ("step",), ("step",), ("step",),
               ("submit", _prompt(11, 6), 14, {})], **BASE)


def test_engine_slot_reuse_under_oversubscription(lm):
    prompts = [_prompt(20 + i, 4 + 3 * i) for i in range(5)]
    eng, _ = _both(lm, _submits(prompts, 6), **dict(BASE, max_batch=2))
    assert all(r.finish_reason in ("eos", "length") for r in eng.finished.values())


def test_engine_int8_kv_cache():
    lm8 = _pair(kv_cache_dtype="int8")
    eng, _ = _both(lm8, _submits([_prompt(30, 7), _prompt(31, 12)], 8),
                   **dict(BASE, max_batch=2))
    assert eng.groups[0].cache["k"].dtype == torch.int8 and "k_scale" in eng.groups[0].cache


@pytest.mark.parametrize("pipelined", [False, True])
def test_engine_streaming_and_budget(lm, pipelined):
    jcfg, tcfg, jp, tp = lm
    kw = dict(BASE, max_batch=2, decode_window=2, pipeline_windows=pipelined)
    eng = TEngine(tcfg, tp, device="cpu", **kw)
    rid = eng.submit(_prompt(40, 5), max_new_tokens=4)
    seen = []
    while eng.has_work:
        seen.extend(eng.step().get(rid, []))
    assert eng.finished[rid].tokens == seen and len(seen) <= 4
    j = JEngine(jcfg, jp, **kw)
    jid = j.submit(_prompt(40, 5), max_new_tokens=4)
    assert j.run()[jid].tokens == seen


def test_decode_window_invariance(lm):
    outs = []
    for window in (1, 3, 8):
        _, got = _both(lm, _submits([_prompt(50 + i, 5 + i) for i in range(3)], 10),
                       **dict(BASE, max_batch=2, decode_window=window))
        outs.append(got)
    assert outs[0] == outs[1] == outs[2]


def test_chunked_prefill_engine_matches_monolithic(lm):
    outs = []
    for chunk in (0, 8):
        script = [("submit", _prompt(60, 6), 10, {}), ("step",),
                  *_submits([_prompt(61, 29), _prompt(62, 17)], 10)]
        _, got = _both(lm, script, **dict(BASE, max_batch=2, decode_window=2,
                                          prefill_chunk=chunk))
        outs.append(got)
    assert outs[0] == outs[1]


def test_chunk_size_not_dividing_max_len(lm):
    """3 chunks of 16 (the last pads 3 to 16) into a 48-position scratch,
    clipped to the 40-position pool."""
    p = _prompt(70, 35)
    _, (got,) = _both(lm, _submits([p], 4), max_batch=1, max_len=40, eos_token=EOS,
                      prefill_bucket=8, decode_window=2, prefill_chunk=16)
    assert got == _port_reference(lm, p, 4, EOS)


def test_prompt_near_max_len_gets_second_token(lm):
    eng, (got,) = _both(lm, _submits([_prompt(71, 31)], 10), max_batch=1, max_len=32,
                        eos_token=-1, prefill_bucket=8, decode_window=1)
    assert len(got) == 2 and eng.finished[0].finish_reason == "length"


def test_bucket_padding_clamped_to_max_len(lm):
    # s = 33 rounds up to 48 > max_len 36: only the clamp lets it prefill
    _, (got,) = _both(lm, _submits([_prompt(72, 33)], 3), max_batch=1, max_len=36,
                      eos_token=-1, prefill_bucket=16, decode_window=1)
    assert len(got) == 3


def test_size_classed_pools_route_and_match(lm):
    _, tcfg, _, tp = lm
    kw = dict(cache_classes=((2, 128), (4, 32)), eos_token=-1, prefill_bucket=8,
              decode_window=2)
    long_p = _prompt(80, 60)
    shorts = [_prompt(81 + i, 6) for i in range(4)]
    eng = TEngine(tcfg, tp, device="cpu", **kw)
    rid_long = eng.submit(long_p, max_new_tokens=6)
    for p in shorts:
        eng.submit(p, max_new_tokens=5)
    eng._admit({})
    small, big = eng.groups
    assert small.max_len == 32 and big.max_len == 128
    assert any(s is not None and s.req_id == rid_long for s in big.slots)
    assert sum(s is not None for s in small.slots) >= 3
    assert eng.resident_cache_positions == 2 * 128 + 4 * 32
    _both(lm, [("submit", long_p, 6, {}), *_submits(shorts, 5)], **kw)


def test_piggybacked_chunk_with_active_decode(lm, monkeypatch):
    calls = []
    orig = teng._decode_with_chunk
    monkeypatch.setattr(teng, "_decode_with_chunk",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    _both(lm, [("submit", _prompt(90, 5), 10, {}), ("submit", _prompt(91, 60), 4, {})],
          max_batch=2, max_len=96, eos_token=-1, prefill_bucket=8, decode_window=2,
          prefill_chunk=16)
    assert len(calls) >= 2  # chunks rode decode dispatches


def test_mixed_trace_drains_with_classes(lm):
    rng = np.random.RandomState(0)
    script = [("submit", _prompt(100 + i, int(rng.choice([4, 9, 20, 70]))),
               int(rng.choice([3, 6])), {}) for i in range(24)]
    _both(lm, script, cache_classes=((2, 128), (6, 32)), eos_token=-1, prefill_bucket=8,
          decode_window=3, prefill_chunk=32)


def _count_mixed(monkeypatch):
    calls = []
    orig = teng._batched_sampler
    monkeypatch.setattr(teng, "_batched_sampler",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def test_per_request_sampling_mixed_batch(lm, monkeypatch):
    """A greedy request and a top_k = 1 one in the same window: the window
    takes the per-row sampler and both give the greedy tokens."""
    calls = _count_mixed(monkeypatch)
    p0, p1 = _prompt(200, 6), _prompt(201, 9)
    _, got = _both(lm, [("submit", p0, 8, {}),
                        ("submit", p1, 8, dict(temperature=0.8, top_k=1))], **BASE)
    assert calls
    assert got == [_port_reference(lm, p0, 8, EOS), _port_reference(lm, p1, 8, EOS)]


def test_per_request_sampling_static_path_when_uniform(lm, monkeypatch):
    calls = _count_mixed(monkeypatch)
    _both(lm, _submits([_prompt(210, 5), _prompt(211, 7)], 6), **dict(BASE, max_batch=2))
    assert not calls


def test_per_request_sampling_with_chunked_prefill(lm):
    _both(lm, [("submit", _prompt(220, 5), 8, {}),
               ("submit", _prompt(221, 40), 4, dict(temperature=1.0, top_k=1))],
          max_batch=2, max_len=96, eos_token=-1, prefill_bucket=8, decode_window=2,
          prefill_chunk=16)


def test_per_request_sampling_varies_output(lm):
    """A temperature > 0 unfiltered request samples: over a few seeds its
    tokens leave the greedy ones at least once."""
    _, tcfg, _, tp = lm
    greedy = _port_reference(lm, _prompt(230, 6), 10, -1)
    outs = []
    for seed in range(4):
        eng = TEngine(tcfg, tp, device="cpu", max_batch=1, max_len=64, eos_token=-1,
                      prefill_bucket=8, seed=seed)
        rid = eng.submit(_prompt(230, 6), max_new_tokens=10, temperature=1.5)
        outs.append(eng.run()[rid].tokens)
    assert any(o != greedy for o in outs)
    again = TEngine(tcfg, tp, device="cpu", max_batch=1, max_len=64, eos_token=-1,
                    prefill_bucket=8, seed=0)
    rid = again.submit(_prompt(230, 6), max_new_tokens=10, temperature=1.5)
    assert again.run()[rid].tokens == outs[0]  # the seed fixes the draws


def test_pipelined_matches_unpipelined(lm):
    outs = []
    for pipelined in (False, True):
        script = [("submit", _prompt(300 + i, 4 + 3 * i), 7,
                   dict(temperature=0.8, top_k=1) if i == 2 else {}) for i in range(5)]
        _, got = _both(lm, script, **dict(BASE, max_batch=2, decode_window=3,
                                          pipeline_windows=pipelined))
        outs.append(got)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_engine_quantized_weights_match_jax(bits):
    """The same quantized packs in both engines; the b <= 8 decode windows
    take the per-layer products with K5's plain version (int8) or the
    boundary's (int4)."""
    lmq = _pair(recipe=bits)
    assert "fused" in lmq[3]["blocks"]["adapter_mlp"]
    prompts = [_prompt(i, s) for i, s in ((41, 5), (42, 11), (43, 8))]
    _, got = _both(lmq, _submits(prompts, 12), **BASE)
    for toks, p in zip(got, prompts):
        assert toks == _port_reference(lmq, p, 12, EOS)


def test_serving_imports_without_jax():
    """The engine and the serving ops import with jax blocked and pull in
    nothing of the JAX package; the package exports the engines lazily."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "import magma_tpu_torch as m, magma_tpu_torch.serving, magma_tpu_torch.ops.sampling\n"
            "assert m.LMServingEngine is magma_tpu_torch.serving.LMServingEngine\n"
            "assert m.MagmaServingEngine is magma_tpu_torch.serving.MagmaServingEngine\n"
            "assert not [k for k in sys.modules if k.split('.')[0] == 'magma_tpu']\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_engine_defaults_to_the_gpu(lm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp = lm
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(tcfg, tp)


# ---------------------------------------------------------------------------
# MagmaServingEngine: images and text in, strings out
# ---------------------------------------------------------------------------

ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)


def _mm_kwargs():
    return dict(batch_size=1, train_steps=1, encoder_name="clip_resnet_large",
                adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
                lm_overrides=dict(n_layers=2, n_heads=4, d_model=128, d_ff=512, rotary_dim=16,
                                  max_seq_len=128, attention_impl="xla"),
                image_size=64, compute_dtype="float32", param_dtype="float32",
                frozen_dtype="float32", attention_impl="xla")


def test_magma_serving_engine_end_to_end(tmp_path):
    jm = JMagma(JConfig(**_mm_kwargs(), encoder_overrides=dict(ENC, compute_dtype=jnp.float32)),
                rng=0)
    r = np.random.default_rng(0)  # the near-zero adapters moved so they matter
    jm.params["lm"]["blocks"]["adapter_mlp"] = jax.tree_util.tree_map(
        lambda a: a + r.standard_normal(a.shape).astype(np.float32) * 0.05,
        jm.params["lm"]["blocks"]["adapter_mlp"])
    sd = to_torch_state_dict(jm.params, jm.state, jm.lm_config, jm.prefix_config)
    path = tmp_path / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    tm = TMagma.from_checkpoint(
        TConfig(**_mm_kwargs(), encoder_overrides=dict(ENC, compute_dtype=torch.float32)),
        path, device="cpu")
    img = Image.fromarray(np.random.default_rng(7).integers(0, 256, (48, 80, 3), np.uint8))
    texts = []
    for eng in (JMagmaEngine(jm, max_batch=2, max_len=128, prefill_bucket=8, decode_window=2),
                TMagmaEngine(tm, max_batch=2, max_len=128, prefill_bucket=8, decode_window=2)):
        ids = [eng.submit_prompt([img, "a picture of"], max_new_tokens=5),
               eng.submit_prompt([img, "describe:"], max_new_tokens=5)]
        eng.run()
        assert all(1 <= len(eng.finished[i].tokens) <= 5 for i in ids)
        texts.append([eng.text_results()[i] for i in ids])
    assert texts[1] == texts[0] and all(isinstance(t, str) for t in texts[1])
    assert isinstance(eng.finished[ids[0]], FinishedRequest)
