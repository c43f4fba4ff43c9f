"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference, each number with its limit (the cell file's
``correct``).

* ``served``: the widest gap by which a served greedy token's logit lies
  below the reference's best, over a sample of the finished requests drawn
  from the seed with the longest in it (``logit_gap``).
* ``sampled``: the draws of the program's sampler that the probe kept,
  judged on the logits the sampler saw against the sampler's stated
  semantics (``nucleus_gap``, ``sample_z``: ``reference/sampler_ref.py``).
* ``train``: over the steps set-up drove, the worst step's loss
  (``loss_gap``: relative), and by the worst leaf the first gradient as the
  optimizer took it (``grad_gap``), the parameters' change (``change_gap``)
  and the BatchNorm statistics' change (``bn_gap``): the gap between the
  program's norm and the reference's over the larger of the reference's
  norm of that leaf and of the median leaf.  Leaves whose first reference
  gradient is under ``exclude_below`` of the median leaf's are left out of
  the gradient and change numbers (rounding moves them under Adam); the
  median is over the leaves the reference gives a gradient.
"""

from __future__ import annotations

import statistics
from typing import Dict, List


def served(cell, seed: int, sample: List, bank, device: str, control: bool = False) -> Dict:
    """Readings of the served sample against the reference of the cell's
    language-model family; with ``control`` also the control's:
    the gap of the token a reference in the nearest lower precision (int4
    weights) puts first."""
    import torch

    from portbench.harness import materialize
    from portbench.reference.magma_ref import gaps, strict_fp32

    strict_fp32()
    fam, model = cell.family(), cell.config["model"]
    weights = fam.make_weights(model, seed, device)
    with torch.no_grad():
        embeds = [fam.embed_prompt(weights, materialize(req, bank), model, device)
                  for req, _ in sample]
        tokens = [list(t) for _, t in sample]
        logits = fam.lm_logits(weights, model, embeds, tokens,
                               bits=cell.config["serving"]["bits"], head_bits=8)
        out = {"logit_gap": float(gaps(logits, tokens).max())}
        if control:
            low = fam.lm_logits(weights, model, embeds, tokens, bits=4, head_bits=8)
            firsts = [lg.argmax(dim=-1).tolist() for lg in low]
            out["control"] = {"logit_gap": float(gaps(logits, firsts).max())}
    out["tokens_compared"] = sum(len(t) for t in tokens)
    out["requests_compared"] = len(tokens)
    return out


def sampled(captures: List) -> Dict:
    """Readings of the kept sampler calls (all zero where none was kept)."""
    from portbench.reference import sampler_ref

    return sampler_ref.readings(captures)


def _norm(t) -> float:
    return float(t.double().norm())


def _worst(got: Dict, ref: Dict, keep=None) -> float:
    """max over the compared leaves of |got - ref| / max(ref, median ref) of
    their norms (the median over those leaves; a leaf both sides leave at 0
    reads 0, one only the program moves reads 1)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    out = 0.0
    for k in keys:
        den = max(ref[k], med)
        out = max(out, abs(got[k] - ref[k]) / den if den > 0 else float(got[k] != 0))
    return out


def train_readings(got: Dict, ref: Dict, init: Dict, stats0: Dict, exclude_below: float) -> Dict:
    """``got`` and ``ref``: {"losses", "grads", "params", "stats"} of the
    same steps from the same weights (``init``, ``stats0``)."""
    loss = max(abs(g - r) / abs(r) for g, r in zip(got["losses"], ref["losses"]))
    g_ref = {k: _norm(v) for k, v in ref["grads"].items()}
    med = statistics.median(v for v in g_ref.values() if v > 0)  # of the leaves with one
    keep = {k for k, v in g_ref.items() if v >= exclude_below * med}
    g_got = {k: _norm(got["grads"][k]) for k in g_ref}
    c_ref = {k: _norm(ref["params"][k] - init[k]) for k in g_ref}
    c_got = {k: _norm(got["params"][k].float() - init[k]) for k in g_ref}
    s_ref = {k: _norm(ref["stats"][k] - stats0[k]) for k in stats0}
    s_got = {k: _norm(got["stats"][k] - stats0[k]) for k in stats0}
    return {"loss_gap": loss, "grad_gap": _worst(g_got, g_ref, keep),
            "change_gap": _worst(c_got, c_ref, keep), "bn_gap": _worst(s_got, s_ref),
            "leaves_compared": len(keep), "leaves_left_out": len(g_ref) - len(keep)}


def train(cell, seed: int, trained: Dict, device: str, control: bool = False) -> Dict:
    """The reference of the cell's language-model family follows the steps
    set-up drove; with ``control`` also the control (the reference with
    every product's operands in float8, the precision below bf16) against
    it."""
    import torch

    from portbench.feed import batch
    from portbench.reference.magma_ref import strict_fp32
    from portbench.reference.train_ref import paths

    strict_fp32()
    fam, p, model = cell.family(), cell.params, cell.config["model"]
    recipe = dict(cell.config["recipe"], ga=p["ga"], micro_batch=p["micro_batch"],
                  image_side=p["image_side"])
    steps = len(trained["losses"])
    seq = model["lm"]["max_seq_len"]
    batches = [batch(p, seed, k, seq, model["eos_token"]) for k in range(steps)]

    def reference(low_precision=False):
        weights = fam.make_weights(model, seed, device)
        return fam.run_steps(weights, model, recipe, batches, seed, device, steps,
                             low_precision)

    weights = fam.make_weights(model, seed, device)
    init = {k: t.detach().clone().float() for k, t in fam.trainable_init(weights).items()}
    stats0 = {k: t.clone() for k, t in paths(weights["stats"]["enc"])}
    del weights
    with torch.enable_grad():
        ref = reference()
    out = train_readings(trained, ref, init, stats0, p["correct"]["exclude_below"])
    out["losses"] = {"program": trained["losses"], "reference": ref["losses"]}
    if control:
        with torch.enable_grad():
            ctl = reference(low_precision=True)
        out["control"] = train_readings(ctl, ref, init, stats0, p["correct"]["exclude_below"])
    return out
