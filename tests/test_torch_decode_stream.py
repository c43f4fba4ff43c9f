"""The host side of the streamed whole-layer decode (K7, K8): the work
partition that ``csrc/decode_layer.cu`` walks in its producer and consumer
warps (``stream_plan``, ``stream_schedule``), the tiles it cuts the stacks
into, its scratch, its gate and the reading of its phase stamps.  No GPU."""

import itertools

import pytest
import torch

from magma_tpu_torch.ops import decode_layer as dl

# GPT-J 6B (the slice's model) and the CUDA tests' small geometry
GEOMETRIES = {
    "gptj": dict(d=4096, f=16384, h=16, max_len=256, layers=28),
    "small": dict(d=2048, f=2048, h=8, max_len=256, layers=3),
}
ADAPTERS = {"none": (0, 0), "v1": (0, 1024), "both": (1024, 1024), "ragged": (384, 640)}


def _plan(geo, wf, adapters):
    g = GEOMETRIES[geo]
    return dl.stream_plan(d=g["d"], f=g["f"], ni=3 * g["d"] + g["f"], h=g["h"], wf=wf,
                          dh=ADAPTERS[adapters])


def _expected_items(plan, h, pos, l0, l1, in_until):
    """Every (layer, phase, item) a launch must run, from the plan alone."""
    nci = max(-(-pos // dl.ATT_CHUNK), 1)
    n = {"attention": h * nci, "dual": (plan["cho"] + plan["chf"]) * plan["td"],
         "adapter_down": plan["cdn"] * sum(plan["tdn"]),
         "adapter_up": sum(plan["cup"]) * plan["td"], "in_proj": plan["cin"] * plan["ti"]}
    adapters = any(plan["tdn"])
    out = set()
    for layer in range(l0, l1):
        for phase in n:
            if phase.startswith("adapter") and not adapters:
                continue
            if phase == "in_proj" and layer >= in_until:
                continue
            out.update((layer, phase, i) for i in range(n[phase]))
    return out


@pytest.mark.parametrize("launch", ["k8", "k7_middle", "k7_last"])
@pytest.mark.parametrize("pos", [0, 1, 16, 17, 180, 255])
@pytest.mark.parametrize("adapters", ["none", "v1", "both"])
@pytest.mark.parametrize("wf", ["int4", "int8"])
def test_every_item_goes_to_exactly_one_block(wf, adapters, pos, launch):
    g = GEOMETRIES["gptj"]
    plan = _plan("gptj", wf, adapters)
    L = g["layers"]
    l0, l1, in_until = {"k8": (0, L, L - 1), "k7_middle": (13, 14, 14),
                        "k7_last": (L - 1, L, L - 1)}[launch]
    grid = 132
    sched = dl.stream_schedule(plan, h=g["h"], pos=pos, grid=grid, l0=l0, l1=l1,
                               in_until=in_until)
    taken = [(layer, phase, i) for items in sched.values() for layer, phase, i, _ in items]
    assert len(taken) == len(set(taken))
    assert set(taken) == _expected_items(plan, g["h"], pos, l0, l1, in_until)
    # within a kind of items no block takes two more than another
    for layer, phase in {(la, ph) for la, ph, _ in taken}:
        counts = [sum(1 for la, ph, _, _ in items if (la, ph) == (layer, phase))
                  for items in sched.values()]
        assert max(counts) - min(counts) <= 1, (layer, phase)
    # and over the launch, the ring tiles a block streams differ by one a kind at most
    tiles = [sum(1 for *_, t in items if t is not None) for items in sched.values()]
    assert max(tiles) - min(tiles) <= len(dl.PHASES) * (l1 - l0)


@pytest.mark.parametrize("adapters", ["v1", "both", "ragged"])
@pytest.mark.parametrize("wf", ["int4", "int8"])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_tiles_cover_every_stack_once(geo, wf, adapters):
    """Each product's (K chunk, column tile) items cover its stack: the
    chunks' 256 rows (int4: packed rows) make its rows, except an adapter's
    ragged last chunk, which the tensor map fills with zeros; the tiles'
    128 columns make its columns."""
    g = GEOMETRIES[geo]
    plan = _plan(geo, wf, adapters)
    d, f, ni = g["d"], g["f"], 3 * g["d"] + g["f"]
    packed = 2 if wf == "int4" else 1
    dh = ADAPTERS[adapters]
    assert (plan["cho"] + plan["chf"]) * dl.TILE_ROWS == (d + f) // packed
    assert plan["cho"] * dl.TILE_ROWS == d // packed
    assert plan["cin"] * dl.TILE_ROWS == d // packed
    assert plan["td"] * dl.TILE_COLS == d and plan["ti"] * dl.TILE_COLS == ni
    assert plan["cdn"] * dl.TILE_ROWS == d
    for k in range(2):
        assert plan["tdn"][k] * dl.TILE_COLS == dh[k]
        assert 0 <= plan["cup"][k] * dl.TILE_ROWS - dh[k] < dl.TILE_ROWS
    sched = dl.stream_schedule(plan, h=g["h"], pos=180, grid=132, l0=0, l1=2, in_until=1)
    seen = {}
    for items in sched.values():
        for layer, phase, _, tile in items:
            if layer == 0 and tile is not None:
                seen.setdefault(tile[0], set()).add(tile[1:])
    assert seen["dual"] == set(itertools.product(range(plan["cho"] + plan["chf"]),
                                                 range(plan["td"])))
    assert seen["in_proj"] == set(itertools.product(range(plan["cin"]), range(plan["ti"])))
    for k in range(2):
        assert {t[1:] for t in seen["wd"] if t[0] == k} == set(
            itertools.product(range(plan["cdn"]), range(plan["tdn"][k])))
        assert {t[1:] for t in seen["wu"] if t[0] == k} == set(
            itertools.product(range(plan["cup"][k]), range(plan["td"])))


@pytest.mark.parametrize("adapters", sorted(ADAPTERS))
@pytest.mark.parametrize("wf", ["int4", "int8"])
def test_scratch_holds_every_phase(wf, adapters):
    """The terms and counters the wrapper allocates cover each phase: a
    chunk term per (chunk, column), the dual's and adapter up's in one
    region, adapter down's and the in_proj's in the other (a phase reads
    the region the one before it wrote while the grid writes the other);
    a counter per dual or in_proj column tile, then one per attention head."""
    g = GEOMETRIES["gptj"]
    plan = _plan("gptj", wf, adapters)
    d, f, ni, h = g["d"], g["f"], 3 * g["d"] + g["f"], g["h"]
    dh = ADAPTERS[adapters]
    region_a = [(plan["cho"] + plan["chf"]) * d, 2 * max(plan["cup"]) * d]
    region_b = [2 * plan["cdn"] * max(dh), plan["cin"] * ni]
    assert plan["terms_a"] == max(region_a)
    assert plan["terms"] == max(region_a) + max(region_b)
    assert plan["counters"] == max(plan["td"], plan["ti"]) + h
    if wf == "int4":  # W4A8 chunks are 512-value groups
        assert plan["cho"] == d // 512 and plan["chf"] == f // 512
    else:
        assert plan["cho"] == d // 256 and plan["chf"] == f // 256


def test_shared_memory_bound_of_the_gate():
    """GPT-J 6B fits the kernel's activation buffer in both formats; an
    int8 d_ff past it, or a d_model whose LN rows do not fit, does not."""
    assert dl._stream_fits(4096, 16384, "int4") and dl._stream_fits(4096, 16384, "int8")
    assert dl._stream_fits(4096, 32768, "int4") and not dl._stream_fits(4096, 32768, "int8")
    assert not dl._stream_fits(8448, 16384, "int4")


@pytest.mark.parametrize("adapters", [False, True])
def test_barrier_count(adapters):
    """Grid barriers a K8 launch crosses: after the attention and the dual
    (and both adapter phases) of every layer, after the in_proj of all but
    the last: 139 for GPT-J with the v1 adapter, where the per-phase body
    crossed 249."""
    L = 28
    per_layer = 4 if adapters else 2
    assert dl.stream_barriers(L, adapters) == L * per_layer + L - 1
    if adapters:
        assert dl.stream_barriers(L, adapters) == 139


def test_phase_breakdown_reads_the_stamps():
    """Per phase, the slowest block's end minus the first block's start,
    summed over layers; the barrier after it up to the next phase's first
    start; a phase a layer lacks (all zero) is skipped."""
    st = torch.zeros((2, 2, len(dl.PHASES), 2), dtype=torch.int64)
    t = 1_000_000
    for layer in range(2):
        for ph in (0, 1, 4):  # no adapter phases
            for b in range(2):
                st[b, layer, ph, 0] = t + 100 * b
                st[b, layer, ph, 1] = t + 1000 + 500 * b
            t += 3000
    out = dl.phase_breakdown(st)
    first, _, down, up, last = dl.PHASES
    assert out[first] == pytest.approx(2 * 1500 / 1e6)
    assert out[down] == 0.0 and out[up] == 0.0
    assert out[f"{first} barrier"] == pytest.approx(2 * 1500 / 1e6)
    assert out[f"{last} barrier"] == pytest.approx(1500 / 1e6)  # the last has none after it
    assert out["total"] == pytest.approx((6 * 3000 - 3000 + 1500) / 1e6)
