"""The host side of the streamed boundary (K6) and fused adapter (K5): the
work partition that ``csrc/boundary.cu`` walks in its producer and consumer
warps (``boundary_plan``, ``boundary_schedule``), the scratch both kernels
take, and the reading of K6's phase stamps.  No GPU."""

import itertools

import pytest
import torch

from magma_tpu_torch.ops import quant

# GPT-J 6B (the slice's model), the CUDA tests' small widths, a ragged one
GEOMETRIES = {
    "gptj": dict(d=4096, f=16384, ni=3 * 4096 + 16384),
    "small": dict(d=512, f=1024, ni=2560),
    "wide_f": dict(d=1024, f=8192, ni=128),
}
ADAPTERS = {"none": (0, 0), "v1": (0, 1024), "both": (1024, 1024), "ragged": (384, 640)}
GRIDS = (132, 7, 1)


def _plan(geo, adapters, m=8, last=False):
    g = GEOMETRIES[geo]
    return quant.boundary_plan(m=m, d=g["d"], f=g["f"], ni=0 if last else g["ni"],
                               dh=ADAPTERS[adapters])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("adapters", list(ADAPTERS))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_every_item_goes_to_exactly_one_block(geo, adapters, grid):
    plan = _plan(geo, adapters)
    sched = quant.boundary_schedule(plan, grid)
    seen = {}
    for b, items in sched.items():
        for phase, i in dict.fromkeys((phase, i) for phase, i, _ in items):
            assert (phase, i) not in seen, f"{phase} item {i} in blocks {seen[(phase, i)]}, {b}"
            seen[(phase, i)] = b
    for phase, n in plan["items"].items():
        if phase.startswith("adapter") and not any(ADAPTERS[adapters]):
            assert n == 0
        got = sorted(i for (ph, i) in seen if ph == phase)
        assert got == list(range(n)), phase
    # a block's items of a phase are contiguous and in order: the codes of
    # a W4A8 group are made once where a block's range enters it
    for items in sched.values():
        for phase, grp in itertools.groupby(items, key=lambda e: e[0]):
            idx = list(dict.fromkeys(i for _, i, _ in grp))
            assert idx == list(range(idx[0], idx[0] + len(idx)))


@pytest.mark.parametrize("adapters", list(ADAPTERS))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_tiles_cover_every_stack_once(geo, adapters):
    """Every 256 x 128 tile of the dual, each adapter's Wd and Wu and the
    in_proj is read by exactly one item."""
    g = GEOMETRIES[geo]
    d, f, ni = g["d"], g["f"], g["ni"]
    dh = ADAPTERS[adapters]
    plan = _plan(geo, adapters)
    tiles = [t for items in quant.boundary_schedule(plan, 132).values() for _, _, t in items]
    assert len(tiles) == len(set(tiles))
    want = {("dual", grp, t) for grp in range((d + f) // 512) for t in range(d // 128)}
    want |= {("in", grp, t) for grp in range(d // 512) for t in range(ni // 128)}
    for a, k in enumerate(dh):
        if k:
            want |= {("wd", a, c, t) for c in range(-(-d // 256)) for t in range(k // 128)}
            want |= {("wu", a, st, sl) for st in range(-(-k // 1024)) for sl in range(d // 32)}
    assert set(tiles) == want


@pytest.mark.parametrize("last", [False, True], ids=["w_in", "last_layer"])
@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("adapters", list(ADAPTERS))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_scratch_holds_every_phase(geo, adapters, m, last):
    """The nonce and the counters, then the terms region (large enough for
    each phase's chunk terms), a and m, each adapter's h: in order, apart."""
    g = GEOMETRIES[geo]
    d, f, ni = g["d"], g["f"], 0 if last else g["ni"]
    dh = ADAPTERS[adapters]
    plan = _plan(geo, adapters, m=m, last=last)
    off = plan["offsets"]
    assert off["terms"] >= 8 + 4 * plan["n_counters"]
    phases = [(d + f) // 512 * m * d, -(-d // 256) * m * sum(dh), d // 512 * m * ni]
    assert off["ab"] - off["terms"] >= 4 * max(phases)
    act = 2 * m * d if any(dh) else 0
    assert off["mb"] - off["ab"] >= act and off["h_attn"] - off["mb"] >= act
    assert off["h_mlp"] - off["h_attn"] >= 2 * m * dh[0]
    assert off["bytes"] - off["h_mlp"] >= 2 * m * dh[1]
    assert all(v % 256 == 0 for v in off.values())


@pytest.mark.parametrize("adapters", list(ADAPTERS))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_counters_are_apart(geo, adapters):
    """The grid barrier's counter, then one a column tile of the dual, of
    each adapter's down product and of the in_proj."""
    plan = _plan(geo, adapters)
    c = plan["counters"]
    d = GEOMETRIES[geo]["d"]
    assert c["dual"] == 1
    assert c["down"] - c["dual"] == d // 128
    assert c["in"] - c["down"] == sum(plan["tdn"])
    assert plan["n_counters"] - c["in"] == plan["ti"]


@pytest.mark.parametrize("m", [1, 8, 16, 33, 64])
@pytest.mark.parametrize("d, dh", [(512, 128), (4096, 1024), (384, 640)])
def test_adapter_scratch_holds_the_down_product(m, d, dh):
    """K5's scratch: the nonce, 1 + dh/128 counters, the down product's
    chunk terms (fp32), h (bf16)."""
    n = quant.adapter_scratch_bytes(m, d, dh)
    counters = 1 + dh // 128
    terms = -(-d // 256) * m * dh
    assert n >= 8 + 4 * counters + 4 * terms + 2 * m * dh
    assert n - 2 * m * dh >= 256  # h starts 256-byte aligned after the rest


def test_phase_breakdown_reads_the_stamps():
    """Per phase the slowest block's end minus the first block's start,
    the wait before the next phase, the launch's total; phases no block
    ran (no adapters) are left out."""
    n = len(quant.BOUNDARY_PHASES)
    stamps = torch.zeros((3, n, 2), dtype=torch.int64)
    t = 1_000_000
    for i in (0, 1, 5, 6, 7):  # no adapters
        for b in range(3):
            stamps[b, i, 0] = t + 100 * b
            stamps[b, i, 1] = t + 1000 + 100 * b
        t += 2000
    out = quant.phase_breakdown(stamps)
    assert list(k for k in out if "wait" not in k) == ["dual", "dual sums", "LN", "in_proj",
                                                      "in_proj sums", "total"]
    assert out["dual"] == pytest.approx(1200 / 1e6)
    assert out["dual wait"] == pytest.approx(800 / 1e6)
    assert out["total"] == pytest.approx((4 * 2000 + 1200) / 1e6)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise and count nothing (the
    public entries take the plain versions there)."""
    x = torch.zeros((2, 512), dtype=torch.bfloat16)
    fz = quant.quantize_adapter_fused(torch.zeros((2, 512, 128)), torch.zeros((2, 128)),
                                      torch.zeros((2, 128, 512)), torch.zeros((2, 512)))
    before = quant.fused_adapter_kernel.launches, quant.boundary_kernel.launches
    with pytest.raises(ValueError):
        quant.fused_adapter_kernel(x, fz, 0)
    with pytest.raises(ValueError):
        quant.boundary_kernel(x, torch.zeros((2, 1024), dtype=torch.bfloat16), x,
                              {"q4": torch.zeros((2, 768, 512), dtype=torch.int8),
                               "s4": torch.zeros((2, 6, 512))},
                              torch.zeros((2, 512)), torch.zeros((2, 512)),
                              torch.zeros((2, 512)), 0)
    assert (quant.fused_adapter_kernel.launches, quant.boundary_kernel.launches) == before
