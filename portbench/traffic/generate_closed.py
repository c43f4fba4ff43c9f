"""One client in a closed loop on ``Magma.generate`` (after the
configuration's ``quantize_for_serving``): preprocess and embed a request,
generate its caption or answer, then the next.  Measures each request's time
from its due time (the previous one's end) to its last token.

Set-up: the weights from the seed, the serving layout, and the first
``warm_requests`` requests of the list (greedy and sampled, captions and
questions: every shape the window runs)."""

import math
import time
from pathlib import Path

from portbench.mix import image_bank, make_requests
from portbench.serve import (INT8_WRAPPERS, SamplerProbe, prompt_inputs, request_flops,
                             sampling_kw, setup_model, slice_steps)
from portbench.trace import Slice, span


def _one(ctx, model, req, bank):
    import torch

    on_card = ctx.device == "cuda"
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
    with span("embed"):
        if ev:
            ev[0].record()
        emb = model.preprocess_inputs(prompt_inputs(model, req, bank, ctx.device))
        if ev:
            ev[1].record()
    g = torch.Generator(device=ctx.device).manual_seed(
        (int(ctx.seed) * 1_000_003 + req.index) % 2 ** 63)
    timing = {}
    with span("generate"):
        toks = model.generate(emb, max_steps=req.max_new, decode=False, generator=g,
                              timing=timing, **sampling_kw(req))
    return [int(t) for t in toks[0, :timing["steps"]]], timing, ev


def run(ctx):
    import torch

    from portbench.harness import Outcome

    p, fam = ctx.cell.params, ctx.cell.family()
    requests = make_requests(p["mix"], ctx.seed)
    bank = image_bank(p["mix"], ctx.seed)
    model = setup_model(ctx)
    n, modes = 0, set()
    while n < p["warm_requests"] or len(modes) < 2:  # at least one greedy, one sampled
        req = requests[n % len(requests)]
        _one(ctx, model, req, bank)
        modes.add(req.greedy)
        n += 1
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"[b1] set-up {setup_s:.2f} s ({n} warm-up requests)")

    traced, sl = slice_steps(ctx), None
    probe = SamplerProbe(p["correct"]["probe_stride"], ctx.seed)
    probe.__enter__()
    rows, t0 = [], time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        req = requests[n % len(requests)]
        n += 1
        if i in traced and sl is None:
            sl = Slice({**INT8_WRAPPERS, **fam.WRAPPERS.get(Path(__file__).stem, {})})
            sl.__enter__()
        due = time.perf_counter()
        tokens, timing, ev = _one(ctx, model, req, bank)
        done = time.perf_counter()
        if sl is not None and i >= traced[-1]:
            sl.__exit__(None, None, None)
        rows.append({"req": req, "tokens": tokens, "ms": 1e3 * (done - due), "timing": timing,
                     "ev": ev, "traced": i in traced, "done": done})
        i += 1
    if sl is not None:  # a window too short for the whole slice
        sl.__exit__(None, None, None)
    probe.__exit__(None, None, None)
    window_s = rows[-1]["done"] - t0
    plain = [r for r in rows if not r["traced"]]
    record = {
        "setup_s": setup_s, "window_s": window_s,
        "latency_ms": [r["ms"] for r in rows],
        "embed_ms": [r["ev"][0].elapsed_time(r["ev"][1]) for r in plain if r["ev"]],
        "prefill_ms": [r["timing"]["prefill_ms"] for r in plain],
        "decode_ms": sum(r["timing"]["decode_ms"] for r in plain),
        "decode_steps": sum(max(r["timing"]["steps"] - 1, 0) for r in plain),
        # mfu's work and time leave out the traced requests, which the profiler slows
        "mfu_flops": sum(request_flops(fam, ctx.cell.config["model"], r["req"],
                                       len(r["tokens"])) for r in plain),
        "mfu_s": sum(r["ms"] for r in plain) / 1e3,
        "trace": sl.reduce() if sl is not None else None,
        "model": ctx.cell.config["model"], "bank": bank,
    }
    lat = sorted(record["latency_ms"])
    p90 = lat[math.ceil(0.9 * len(lat)) - 1]
    ctx.log(f"[b1] window {window_s:.3f} s, {len(rows)} requests, latency ms min "
            f"{lat[0]:.1f} median {lat[len(lat) // 2]:.1f} p90 {p90:.1f} max {lat[-1]:.1f}; "
            f"the 95th percentile has {len(lat) - math.ceil(0.95 * len(lat))} samples beyond it")
    served = [(r["req"], r["tokens"]) for r in rows if r["req"].greedy]
    holder = {"model": model}
    del model
    return Outcome(record, attempted=len(rows), failed=0, served=served,
                   release=holder.clear, sampled=probe.kept)
