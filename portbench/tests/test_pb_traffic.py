"""The traffic generator and the training feed: reproducible by seed, the
stated mix, lengths and budgets, the same amount of work for every seed."""

import collections
import json

import numpy as np
import pytest

from portbench.feed import batch, caption_lengths
from portbench.mix import image_bank, make_requests

from conftest import PORTBENCH

CELLS = ("magma_v1.int8_b1",)


def _mix(cell):
    return json.loads((PORTBENCH / "workloads" / f"{cell}.json").read_text())["mix"]


def _key(r):
    return (r.kind, r.max_new, tuple(sorted(r.sampling.items())),
            tuple(len(v) if k == "text" else -1 for k, v in r.parts))


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_requests(cell):
    mix = _mix(cell)
    a, b = make_requests(mix, 2 ** 31 + 7), make_requests(mix, 2 ** 31 + 7)
    assert [_key(r) for r in a] == [_key(r) for r in b]
    for ra, rb in zip(a, b):
        for (ka, va), (kb, vb) in zip(ra.parts, rb.parts):
            assert ka == kb and np.array_equal(va, vb)
    ia, ib = image_bank(mix, 2 ** 31 + 7), image_bank(mix, 2 ** 31 + 7)
    assert all(np.array_equal(x, y) for x, y in zip(ia, ib))


@pytest.mark.parametrize("cell", CELLS)
def test_seeds_share_the_work_in_another_order(cell):
    mix = _mix(cell)
    a, b = make_requests(mix, 11), make_requests(mix, 4_000_000_000)
    assert collections.Counter(map(_key, a)) == collections.Counter(map(_key, b))
    assert [_key(r) for r in a] != [_key(r) for r in b]
    assert [x.shape for x in image_bank(mix, 11)] == [x.shape for x in image_bank(mix, 12)]


@pytest.mark.parametrize("cell", CELLS)
def test_mix_shares_lengths_and_budgets(cell):
    mix = _mix(cell)
    reqs = make_requests(mix, 3)
    assert len(reqs) == mix["requests"]
    by_kind = collections.Counter(r.kind for r in reqs)
    total = sum(k["share"] for k in mix["kinds"])
    for kind in mix["kinds"]:
        assert abs(by_kind[kind["name"]] - kind["share"] / total * len(reqs)) <= 1
        mine = [r for r in reqs if r.kind == kind["name"]]
        lo, hi = kind["max_new"]
        assert all(lo <= r.max_new <= hi for r in mine)
        assert {r.max_new for r in mine} == set(range(lo, hi + 1))
        for i, part in enumerate(kind["parts"]):
            if part[0] == "text":
                lens = [len(r.parts[i][1]) for r in mine]
                assert min(lens) == part[1] and max(lens) == part[2]
            else:
                assert all(r.parts[i][0] == "image" for r in mine)
        modes = collections.Counter(tuple(sorted(r.sampling.items())) for r in mine)
        shares = sum(m["share"] for m in kind["sampling"])
        for m in kind["sampling"]:
            key = tuple(sorted((k, v) for k, v in m.items() if k != "share"))
            assert abs(modes[key] - m["share"] / shares * len(mine)) <= 1
    assert all("top_k" not in r.sampling for r in reqs)  # never top_k with top_p
    assert any(r.greedy for r in reqs) and not all(r.greedy for r in reqs)
    ids = np.concatenate([v for r in reqs for k, v in r.parts if k == "text"])
    assert ids.min() >= 0 and ids.max() < 50256
    sizes = [x.shape for x in image_bank(mix, 3)]
    assert {s[:2] for s in sizes} == {tuple(s) for s in mix["image_sizes"]}
    assert all(s[2] == 3 for s in sizes)


def test_training_feed():
    w = json.loads((PORTBENCH / "workloads" / "magma_v2.bf16_train.json").read_text())
    lens = caption_lengths(w, 16)
    assert np.median(lens) == pytest.approx(18, abs=2) and lens.max() <= 1904
    x, c = batch(w, 2 ** 33, 4, 2048, 50256)
    x2, c2 = batch(w, 2 ** 33, 4, 2048, 50256)
    assert np.array_equal(x, x2) and np.array_equal(c, c2)
    assert x.shape == (16, 384, 384, 3) and x.dtype == np.uint8 and c.shape == (16, 2048)
    first_eos = [int(np.argmax(row == 50256)) for row in c]
    assert sorted(first_eos) == sorted(lens.tolist())
    _, c5 = batch(w, 2 ** 33, 5, 2048, 50256)
    assert not np.array_equal(c, c5)
    assert sorted(int(np.argmax(row == 50256)) for row in c5) == sorted(first_eos)
