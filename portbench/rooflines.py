"""Roofline shares of a kernel family in the traced slice: for each launch
the program made there, its least time (``cost.least_s`` of its operations
and bytes, from the shapes it was called with), summed, over the family's
device time in the same slice.

The kernels every language-model family may launch are listed here; a
family module lists its own (``ROOFLINES``) and costs their launches
(``least_s``), and is asked first."""

import re
from typing import Dict, Optional

from portbench import cost
from portbench.harness import family

# name -> (kernel name patterns, call kinds)
FAMILIES = {
    # K2a, K2b, K4a (csrc/int8_matmul.cu: GEMV and wgmma tile) and K5
    "int8": ((r"anonymous namespace\)::(gemv_kernel|int8_wgmma_tile_kernel|fused_adapter_kernel)",),
             ("k2", "k4a", "k5")),
    # K1's two bodies (csrc/flash_attn_fwd.cu, flash_attn_fwd_wgmma.cu), K9a
    # and K9b (csrc/flash_attn_bwd.cu)
    "flash": ((r"anonymous namespace\)::flash_(fwd|bwd)",), ("k1", "k9a", "k9b")),
}


def least_s(call, model: Dict, fam) -> float:
    """The least time of one logged launch (``fam``: the family module of
    ``model``)."""
    kind, args = call[0], call[1:]
    if any(kind in kinds for _, kinds in fam.ROOFLINES.values()):
        return fam.least_s(call, model)
    if kind == "k2":
        return cost.least_s(*cost.int8_matmul(*args))
    if kind == "k4a":
        return cost.least_s(*cost.int8_dual(*args))
    if kind == "k5":
        return cost.least_s(*cost.fused_adapter(*args))
    if kind == "k1":
        return cost.least_s(*cost.flash_fwd(*args))
    if kind == "k9a":
        return cost.least_s(*cost.flash_bwd(*args, products=4, outputs=2))
    if kind == "k9b":
        return cost.least_s(*cost.flash_bwd(*args, products=3, outputs=1))
    raise ValueError(f"no cost for a {kind!r} launch")


def share(record: Dict, name: str) -> Optional[float]:
    """The roofline share in % of the slice of the kernel family ``name``
    (the model's language-model family's own, or one listed here), or None
    where the slice ran none of its kernels."""
    summary = record.get("trace")
    if not summary:
        return None
    model = record["model"]
    fam = family(model)
    patterns, kinds = {**FAMILIES, **fam.ROOFLINES}[name]
    pats = [re.compile(p) for p in patterns]
    device = sum(sum(ts) for kname, ts in summary["kernels"].items()
                 if any(p.search(kname) for p in pats))
    least = sum(least_s(c, model, fam) for c in summary["calls"] if c[0] in kinds)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device
