"""Roofline shares of a kernel family in the traced slice: for each launch
the program made there, its least time (``cost.least_s`` of its operations
and bytes, from the shapes it was called with), summed, over the family's
device time in the same slice."""

import re
from typing import Dict, Optional

from portbench import cost

FAMILIES = {
    # K2a, K2b, K4a (csrc/int8_matmul.cu: GEMV and wgmma tile) and K5
    "int8": (r"anonymous namespace\)::(gemv_kernel|int8_wgmma_tile_kernel|fused_adapter_kernel)",),
    # K8 (csrc/decode_layer.cu)
    "k8": (r"anonymous namespace\)::decode_stream_kernel",),
    # K1's two bodies (csrc/flash_attn_fwd.cu, flash_attn_fwd_wgmma.cu), K9a
    # and K9b (csrc/flash_attn_bwd.cu)
    "flash": (r"anonymous namespace\)::flash_(fwd|bwd)",),
}
CALLS = {"int8": ("k2", "k4a", "k5"), "k8": ("k8",), "flash": ("k1", "k9a", "k9b")}


def _position(p) -> int:
    return int(p.reshape(-1)[0]) if hasattr(p, "reshape") else int(p)


def least_s(call, model: Dict) -> float:
    """The least time of one logged launch."""
    kind, args = call[0], call[1:]
    if kind == "k2":
        return cost.least_s(*cost.int8_matmul(*args))
    if kind == "k4a":
        return cost.least_s(*cost.int8_dual(*args))
    if kind == "k5":
        return cost.least_s(*cost.fused_adapter(*args))
    if kind == "k8":
        d = model["lm"]["d_model"]
        widths = [d // a["downsample_factor"] for a in model.get("adapters", {}).values()]
        return cost.least_s(*cost.decode_all_layers(model["lm"], widths, _position(args[0]),
                                                    kv_bytes=args[1]))
    if kind == "k1":
        return cost.least_s(*cost.flash_fwd(*args))
    if kind == "k9a":
        return cost.least_s(*cost.flash_bwd(*args, products=4, outputs=2))
    if kind == "k9b":
        return cost.least_s(*cost.flash_bwd(*args, products=3, outputs=1))
    raise ValueError(f"no cost for a {kind!r} launch")


def share(record: Dict, family: str) -> Optional[float]:
    """The family's roofline share in % of the slice, or None where the
    slice ran none of its kernels."""
    summary = record.get("trace")
    if not summary:
        return None
    pats = [re.compile(p) for p in FAMILIES[family]]
    device = sum(sum(ts) for name, ts in summary["kernels"].items()
                 if any(p.search(name) for p in pats))
    least = sum(least_s(c, record["model"]) for c in summary["calls"]
                if c[0] in CALLS[family])
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device
