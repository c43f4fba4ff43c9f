"""``generate_tokens`` reads its early-exit flag one step late where a decode
step is one fused launch (``gptj.fused_decode``): forward N is queued
before the flag of sample N is read.  Elsewhere it reads the flag first.

Held on the CPU at the whole-layer decode's geometry (8 heads of 256,
d_model and d_ff 2048, 2 layers, the v1 adapter), where the int8 and int4
layouts take K8's plain version at b = 1, the int4 one K6's at b = 2, the
int8 one the per-layer chain at b = 2, and the bf16 tree its own layers:
the tokens, ``steps`` and the generator's final state equal those of a copy
of the loop that reads the flag before each forward, sampled and greedy,
with EOS forced at a step and at a ``max_steps`` exit; the counters say how
many forwards were queued ahead and how many no sample read, and the tokens
come back on the host either way.
"""

import functools

import pytest
import torch

from magma_tpu_torch import observability as obs
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models.adapters import AdapterSpec
from magma_tpu_torch.ops import sampling
from magma_tpu_torch.utils import round_up

NO_EOS = -1
MAX_STEPS = 8
SAMPLED = dict(temperature=0.7, top_p=0.9)
GREEDY = dict(temperature=0.0, top_p=0.0)


@functools.lru_cache(maxsize=None)
def _lm(fmt):
    """(cfg, params) at the K8 gate's geometry: ``fmt`` "int8" or "int4"
    (the fused serving layouts), or "bf16" (the unquantized tree)."""
    cfg = tgptj.GPTJConfig.tiny(n_layers=2, n_heads=8, d_model=2048, d_ff=2048, rotary_dim=64,
                                vocab_size=1000, param_dtype=torch.float32,
                                mlp_adapter=AdapterSpec("normal", 16))
    g = torch.Generator().manual_seed(0)
    p = tgptj.init_params(g, cfg)
    for proj in ("down", "up"):  # trained-scale adapters so they matter
        ad = p["blocks"]["adapter_mlp"][proj]
        ad["kernel"] = torch.randn(ad["kernel"].shape, generator=g) * 0.05
    if fmt == "int8":
        p = tgptj.quantize_lm_params(p)
    elif fmt == "int4":
        p = tgptj.quantize_lm_params_int4(p)
    return cfg, p


def _prompt(b, s=5):
    return torch.randn((b, s, 2048), generator=torch.Generator().manual_seed(1))


def _flag_first(cfg, params, emb, generator, *, max_steps, temperature, top_p, eos_token):
    """``generate_tokens``' loop with the flag read before each forward, as
    it ran before the look-ahead."""
    b, s, _ = emb.shape
    prompt_len = torch.full((b,), s, dtype=torch.int32)
    cache = tgptj.init_kv_cache(cfg, b, round_up(s + max_steps, 64))
    hidden, cache = tgptj.forward(cfg, params, emb, cache=cache, cache_index=0,
                                  kv_len=prompt_len, return_hidden=True)
    last = tgptj.lm_head(cfg, params, hidden[:, -1:])[:, 0]
    tokens = torch.full((b, max_steps), eos_token, dtype=torch.long)
    done = torch.zeros((b,), dtype=torch.bool)
    cur_len, step = prompt_len.clone(), 0
    while step < max_steps:
        tok = sampling.sample_token(generator, last, temperature=temperature, top_k=0,
                                    top_p=top_p, vocab_size=cfg.vocab_size)
        tok = torch.where(done, eos_token, tok)
        tokens[:, step] = tok
        done = done | (tok == eos_token)
        step += 1
        if step == max_steps or bool(done.all()):
            break
        logits, cache = tgptj.forward(cfg, params, tgptj.embed_tokens(cfg, params, tok[:, None]),
                                      cache=cache, cache_index=cur_len)
        last = logits[:, -1]
        cur_len = cur_len + 1
    return tokens, step


def _both(fmt, b, kw, eos_token, max_steps=MAX_STEPS):
    """The port's and the flag-first loop's (tokens, steps, generator state),
    and the port's counters and spans."""
    cfg, params = _lm(fmt)
    emb = _prompt(b)
    g_want = torch.Generator().manual_seed(5)
    want, want_steps = _flag_first(cfg, params, emb, g_want, max_steps=max_steps,
                                   eos_token=eos_token, **kw)
    g_got = torch.Generator().manual_seed(5)
    obs.take()
    timing = {}
    with obs.tracing():
        got, got_steps = sampling.generate_tokens(cfg, params, emb, g_got, max_steps=max_steps,
                                                  top_k=0, eos_token=eos_token, timing=timing,
                                                  **kw)
    spans, counters = obs.take()
    assert timing["decode_ms"] >= 0.0
    return ((want, want_steps, g_want.get_state()), (got, got_steps, g_got.get_state()),
            counters, spans)


def _forced_eos(fmt, kw, k):
    """A token the loop first draws at step ``k``: as EOS, the exit comes
    there."""
    (toks, _, _), _, _, _ = _both(fmt, 1, kw, NO_EOS)
    row = toks[0].tolist()
    k = next(i for i in range(k, MAX_STEPS) if row[i] not in row[:i])
    return row[k], k


def _count(spans, name):
    return sum(1 for s in spans if s.name == name)


PATHS = {("int8", 1): "declayer", ("int4", 1): "declayer", ("int4", 2): "boundary",
         ("int8", 2): None, ("bf16", 1): None}


@pytest.mark.parametrize("fmt,b", [("int8", 1), ("int4", 2), ("int8", 2), ("bf16", 1)])
def test_fused_decode_names_the_k8_and_k6_steps_only(fmt, b):
    """K8 at b = 1 over the int8 layout, K6 at b <= 8 over the int4 one;
    neither for the int8 layout at b = 2 nor for the bf16 tree."""
    cfg, params = _lm(fmt)
    x, cache = torch.zeros((b, 1, cfg.d_model)), tgptj.init_kv_cache(cfg, b, 64)
    assert tgptj.fused_decode(cfg, params["blocks"], x, cache) == PATHS[fmt, b]


@pytest.mark.parametrize("fmt,b", [("int8", 1), ("int4", 2), ("int8", 2), ("bf16", 1)],
                         ids=["k8", "k6", "chain", "bf16"])
@pytest.mark.parametrize("mode", ["sampled", "greedy"])
def test_tokens_steps_and_draws_equal_flag_first(fmt, b, mode):
    """(a) No EOS: the same tokens, ``steps`` and final generator state; on
    the fused steps every decode forward queued ahead of its flag, on the
    others none."""
    want, got, counters, spans = _both(fmt, b, SAMPLED if mode == "sampled" else GREEDY, NO_EOS)
    assert got[1] == want[1] == MAX_STEPS
    assert got[0].device.type == "cpu"
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    forwards = _count(spans, "lm.decode_forward")
    assert forwards == MAX_STEPS - 1
    ahead = counters.get("lm.lookahead_forwards", 0)
    assert ahead == (forwards if PATHS[fmt, b] else 0)


@pytest.mark.parametrize("fmt", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("mode", ["sampled", "greedy"])
def test_eos_exit_wastes_one_forward_where_it_looks_ahead(fmt, mode):
    """(b) EOS forced at step k: the same tokens, ``steps`` and draws.  On
    the fused layouts the forward queued after the EOS sample is the one
    wasted, and the tokens come back from the copy staged before it; (d) the
    bf16 tree reads the flag first and wastes nothing."""
    kw = SAMPLED if mode == "sampled" else GREEDY
    eos, k = _forced_eos(fmt, kw, 3)
    want, got, counters, spans = _both(fmt, 1, kw, eos)
    assert got[1] == want[1] == k + 1 < MAX_STEPS
    assert got[0].device.type == "cpu"
    assert torch.equal(got[0], want[0])
    assert got[0][0, k] == eos and (got[0][0, k + 1:] == eos).all()
    assert torch.equal(got[2], want[2])
    forwards = _count(spans, "lm.decode_forward")
    assert counters["lm.host_reads"] == _count(spans, "lm.eos_check") == got[1]
    if fmt == "bf16":
        assert forwards == got[1] - 1
        assert counters.get("lm.lookahead_forwards", 0) == 0
        assert counters.get("lm.lookahead_wasted", 0) == 0
    else:
        assert forwards == got[1]  # one after each sample, the EOS sample's included
        assert counters["lm.lookahead_forwards"] == forwards
        assert counters["lm.lookahead_wasted"] == 1


def test_max_steps_exit_wastes_nothing():
    """(c) A ``max_steps`` exit: no forward follows the last sample, none is
    wasted, one wait a forward."""
    _, got, counters, spans = _both("int8", 1, GREEDY, NO_EOS, max_steps=4)
    assert got[1] == 4
    assert counters["lm.lookahead_forwards"] == _count(spans, "lm.decode_forward") == 3
    assert counters.get("lm.lookahead_wasted", 0) == 0
    assert counters["lm.host_reads"] == 3
