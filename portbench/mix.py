"""The one request generator: a cell's mix parameters -> a seeded request list.

A mix is data in the cell's file (``portbench/workloads/<cell>.json``):

    "mix": {"kinds": [{"name": "caption", "share": 1,
                       "parts": [["image"], ["text", 5, 5]],
                       "max_new": [11, 19],
                       "sampling": [{"share": 1, "temperature": 0.7, "top_p": 0.9}]},
                      ...],
            "image_sizes": [[480, 640], [427, 640], [640, 480]],
            "images": 48, "requests": 400}

``parts`` is the prompt in order: an image, or text of a length drawn from
[lo, hi].  ``sampling`` splits a kind's requests over sampler settings by
share.  Every seed gets the same requests' shapes (kinds, lengths, budgets
and sampling settings: shares taken exactly, lengths spread evenly over
their ranges, paired alike for every seed), in another order, with its own
token ids and pixels: so seeds differ in content and order, not in the
amount of work.  Images come from a bank of ``images`` uint8 arrays whose
(height, width) cycle through ``image_sizes``; each request draws its
images from the bank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# ids a prompt's text may hold: GPT-2's vocabulary without <|endoftext|>
TEXT_IDS = 50256


@dataclasses.dataclass
class Request:
    index: int
    kind: str
    parts: List            # ("image", bank index) or ("text", int64 ids)
    max_new: int
    sampling: Dict         # temperature, and top_p where it samples

    @property
    def greedy(self) -> bool:
        return self.sampling.get("temperature", 0.0) == 0.0

    def text_len(self) -> int:
        return sum(len(p[1]) for p in self.parts if p[0] == "text")

    def n_images(self) -> int:
        return sum(1 for p in self.parts if p[0] == "image")


def _counts(shares: Sequence[float], n: int) -> List[int]:
    """n split by ``shares`` (largest remainders), summing to n exactly."""
    raw = [s * n / sum(shares) for s in shares]
    out = [int(r) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: out[i] - raw[i])[:n - sum(out)]:
        out[i] += 1
    return out


def _spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi]."""
    return np.floor(lo + (hi - lo + 1) * (np.arange(n) + 0.5) / n).astype(np.int64)


def image_bank(mix: Dict, seed: int) -> List[np.ndarray]:
    """The mix's bank of uint8 (h, w, 3) images: the same sizes for every
    seed (``image_sizes`` in turn), pixels from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    sizes = mix["image_sizes"]
    return [rng.integers(0, 256, (*sizes[i % len(sizes)], 3), dtype=np.uint8)
            for i in range(mix["images"])]


def make_requests(mix: Dict, seed: int, n: Optional[int] = None) -> List[Request]:
    """``n`` (default ``mix["requests"]``) requests of the mix in the seed's
    order."""
    n = int(n or mix["requests"])
    rng = np.random.default_rng([int(seed), 0])
    pair = np.random.default_rng(0)  # pairs lengths, budgets, samplers alike for every seed
    kinds = mix["kinds"]
    per_kind = _counts([k["share"] for k in kinds], n)
    rows = []
    for kind, count in zip(kinds, per_kind):
        lengths = [_spread(p[1], p[2], count) if p[0] == "text" else None
                   for p in kind["parts"]]
        lengths = [pair.permutation(x) if x is not None else None for x in lengths]
        budgets = pair.permutation(_spread(*kind["max_new"], count))
        samplers = kind["sampling"]
        modes = np.concatenate([np.full(c, j) for j, c in
                                enumerate(_counts([s["share"] for s in samplers], count))])
        modes = pair.permutation(modes)
        for i in range(count):
            rows.append((kind, [None if x is None else int(x[i]) for x in lengths],
                         int(budgets[i]), samplers[int(modes[i])]))
    order = rng.permutation(len(rows))
    n_images = mix["images"]
    out = []
    for index, r in enumerate(order):
        kind, lengths, budget, sampler = rows[r]
        parts = []
        for p, length in zip(kind["parts"], lengths):
            if p[0] == "image":
                parts.append(("image", int(rng.integers(n_images))))
            else:
                parts.append(("text", rng.integers(0, TEXT_IDS, length, dtype=np.int64)))
        sampling = {k: v for k, v in sampler.items() if k != "share"}
        out.append(Request(index, kind["name"], parts, budget, sampling))
    return out
