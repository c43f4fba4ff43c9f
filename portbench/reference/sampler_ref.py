"""Plain reference of the sampler's stated semantics, to judge the draws the
program's sampler made from the logits it saw.

The semantics are upstream MAGMA's (magma/sampling.py), as the program
states them for top_p without top_k: ``top_p`` in the "reference" mode
removes, after the first rank, every rank whose preceding cumulative
probability (the softmax of the logits at temperature 1) is under
``1 - top_p`` (upstream's filter as written); the temperature then divides
the kept logits, and the token is drawn from their softmax.  Logits past
``vocab_size`` (the padded rows) are never drawn.  Other settings (top_k,
the "standard" mode) are refused: no cell sends them.

Two numbers, over every sampled row the probe kept, in float64:

* ``nucleus_gap``: the largest probability mass by which a drawn token lies
  inside the removed part of the ranking (1 for a token past the
  vocabulary).  0 where every draw is one the filter allows.
* ``sample_z``: |Z| of the draws' log-probabilities under the stated
  distribution: the sum over draws of log p(token) - E[log p] over the
  square root of the sum of Var[log p].  A sampler that draws from the
  stated distribution gives a standard normal Z; one that draws at another
  temperature, or another token, moves it by the square root of the
  number of draws times the shift a draw.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def judge(logits: torch.Tensor, temperature: float, top_p: float, token: int,
          vocab_size: int):
    """(the token's nucleus gap, its log-probability, E[log p], Var[log p])
    under the stated distribution (log-probability None where the filter
    leaves the token out)."""
    if token >= vocab_size:
        return 1.0, None, 0.0, 0.0
    x = logits[:vocab_size].double()
    if top_p > 0:
        sorted_x, order = torch.sort(x, descending=True, stable=True)
        probs = torch.softmax(sorted_x, dim=0)
        before = torch.cumsum(probs, dim=0) - probs
        remove = before < (1.0 - top_p)
        remove[0] = False
        rank = int((order == token).nonzero()[0, 0])
        if bool(remove[rank]):
            return (1.0 - top_p) - float(before[rank]), None, 0.0, 0.0
        x = x.clone()
        x[order[remove]] = -math.inf
    logp = torch.log_softmax(x / temperature, dim=0)
    p = logp.exp()
    kept = p > 0
    e = float((p[kept] * logp[kept]).sum())
    var = float((p[kept] * logp[kept] ** 2).sum()) - e * e
    return 0.0, float(logp[token]), e, max(var, 0.0)


def readings(captures: List[Dict]) -> Dict:
    """``nucleus_gap``, ``sample_z`` and ``sampled_checked`` over the kept
    calls (see the module docstring)."""
    gap, dev, var, n = 0.0, 0.0, 0.0, 0
    for c in captures:
        if c["top_k"] > 0 or c["mode"] != "reference":
            raise ValueError("only top_p in the reference mode is judged "
                             f"(top_k {c['top_k']}, mode {c['mode']!r})")
        for row, tok in zip(c["logits"].float(), c["tokens"].reshape(-1).tolist()):
            g, lp, e, v = judge(row, c["temperature"], c["top_p"], int(tok), c["vocab_size"])
            gap = max(gap, g)
            n += 1
            if lp is not None:
                dev += lp - e
                var += v
    z = abs(dev) / math.sqrt(var) if var > 0 else 0.0
    return {"nucleus_gap": gap, "sample_z": z, "sampled_checked": n}
