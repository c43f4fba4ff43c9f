"""The training feed: step k's batch of image-caption pairs, made from the
seed on the host as a loader hands them over (uint8 images, int64 caption
ids padded with EOS), so the program and the reference read the same rows.

Caption lengths (tokens before the EOS padding) are the ``batch`` quantile
midpoints of a log-normal (``caption_len``: median and 95th percentile),
so every step has the same multiset of lengths, in another order, and the
same amount of work; ids and pixels differ from row to row and step to
step."""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, Tuple

import numpy as np

from portbench.mix import TEXT_IDS


def caption_lengths(p: Dict, n: int) -> np.ndarray:
    """The n quantile midpoints of the log-normal of ``p["caption_len"]``
    ({"median", "p95", "max"}), whole tokens, at least 1."""
    c = p["caption_len"]
    sigma = math.log(c["p95"] / c["median"]) / NormalDist().inv_cdf(0.95)
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.round(c["median"] * np.exp(sigma * z)), 1, c["max"]).astype(np.int64)


def batch(p: Dict, seed: int, step: int, seq_len: int, eos: int) -> Tuple[np.ndarray, np.ndarray]:
    """Step ``step``'s rows: (uint8 (n, side, side, 3), int64 (n, seq_len))
    with n = ga x micro."""
    n = p["ga"] * p["micro_batch"]
    rng = np.random.default_rng([int(seed), 5, int(step)])
    side = p["image_side"]
    images = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    lengths = rng.permutation(caption_lengths(p, n))
    captions = np.full((n, seq_len), eos, dtype=np.int64)
    for i, length in enumerate(lengths):
        captions[i, :length] = rng.integers(0, TEXT_IDS, length)
    return images, captions
