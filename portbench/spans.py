"""The program's own spans in a traced slice: the ranges that
``magma_tpu_torch.observability.span`` opens while the slice's profiler
records (``record_function`` ranges, "user_annotation" in the Chrome trace
that ``trace.Slice.reduce`` writes), clipped to the slice's ``pb.slice``
range; and the tracer's counters, which count only while that profiler
records, read from the program in this process.

For a set of span names: how many ranges, their wall time, and the device
idle time inside them (the union of the ranges minus the merged kernel,
copy and memset intervals).  A program without the tracer leaves no such
range and no counter: its readings are None, never 0."""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.trace import DEVICE_CATS, TRACE_DIR, _merge

PROGRAM = ("magma.", "vision.", "lm.", "train.", "kernel.")  # the tracer's span names
KERNEL = "kernel."  # the kernel wrappers' spans: a layer of their own, inside the others
SLICE = "pb.slice"


def _intersect(a: List, b: List) -> List:
    """Two sorted, merged interval lists -> their intersection."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a: List, b: List) -> List:
    """Sorted, merged ``a`` minus sorted, merged ``b``."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k, cur = j, lo
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < hi:
            out.append([cur, hi])
    return out


def _length(a: Iterable) -> float:
    return sum(hi - lo for lo, hi in a)


def _matches(name: str, names: Tuple[str, ...]) -> bool:
    """``name`` is one of ``names``, where an entry ending in "." is a prefix."""
    return any(name == n or (n.endswith(".") and name.startswith(n)) for n in names)


class Spans:
    """The program's ranges in one traced slice (times in us of the trace's
    clock), the benchmark's own ``pb.*`` ranges, and the device's merged
    busy intervals, all within the slice."""

    def __init__(self, trace: Dict, slice_name: str = SLICE):
        events = trace.get("traceEvents", trace)
        rng = [e for e in events if e.get("name") == slice_name and e.get("ph") == "X"]
        if not rng:
            raise RuntimeError(f"the trace has no {slice_name} range")
        t0, t1 = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
        dev = []
        self.ranges: List[Tuple[float, float, str, object]] = []  # (start, end, name, thread)
        self.outer: List[Tuple[float, float, str]] = []           # the benchmark's pb.* ranges
        for e in events:
            if e.get("ph") != "X":
                continue
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b <= a:
                continue
            cat, name = e.get("cat"), str(e.get("name", ""))
            if cat in DEVICE_CATS:
                dev.append((a, b))
            elif cat == "user_annotation" and name.startswith(PROGRAM):
                self.ranges.append((a, b, name, e.get("tid")))
            elif cat == "user_annotation" and name.startswith("pb.") and name != slice_name:
                self.outer.append((a, b, name[3:]))
        self.busy = _merge(dev)
        self.counters: Optional[Dict[str, int]] = None

    def pick(self, names: Tuple[str, ...]) -> List:
        return [r for r in self.ranges if _matches(r[2], names)]

    def count(self, names: Tuple[str, ...]) -> int:
        return len(self.pick(names))

    def wall_s(self, names: Tuple[str, ...]) -> float:
        return 1e-6 * sum(b - a for a, b, _, _ in self.pick(names))

    def idle_s(self, names: Tuple[str, ...]) -> float:
        """Device idle time inside the union of the named ranges."""
        union = _merge([(a, b) for a, b, _, _ in self.pick(names)])
        return 1e-6 * _length(_subtract(union, self.busy))

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{span name: {"count", "wall_s", "idle_s"}}."""
        return {n: {"count": self.count((n,)), "wall_s": self.wall_s((n,)),
                    "idle_s": self.idle_s((n,))}
                for n in sorted({r[2] for r in self.ranges})}

    def leaves(self) -> List:
        """The ranges that hold no other program range of their thread, the
        kernel wrappers' aside (a kernel's range is a leaf too)."""
        out = []
        by_thread: Dict = {}
        for r in self.ranges:
            by_thread.setdefault(r[3], []).append(r)
        for rs in by_thread.values():
            rs.sort(key=lambda r: (r[0], -r[1]))
            inner = [r for r in rs if not r[2].startswith(KERNEL)]
            holds = set()
            stack: List = []
            for r in inner:
                while stack and stack[-1][1] < r[1]:
                    stack.pop()
                if stack:
                    holds.add(id(stack[-1]))
                stack.append(r)
            out += [r for r in rs if id(r) not in holds]
        return out

    def leaf_cover(self, outer: str) -> Dict:
        """Of the device idle time inside the benchmark's ``pb.<outer>``
        ranges: the seconds in all, the seconds under a leaf program range,
        and the rest by the innermost program range open over it ("no
        program span" where none is)."""
        within = _merge([(a, b) for a, b, n in self.outer if n == outer])
        idle = _subtract(within, self.busy)
        leaves = _merge([(a, b) for a, b, _, _ in self.leaves()])
        edges = sorted({x for r in self.ranges for x in r[:2]})
        by: Dict[str, float] = {}
        for lo, hi in _subtract(idle, leaves):
            cuts = [lo] + [x for x in edges if lo < x < hi] + [hi]
            for a, b in zip(cuts, cuts[1:]):  # pieces that no range starts or ends in
                mid = (a + b) / 2
                inner = [r for r in self.ranges if r[0] <= mid <= r[1]]
                name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "no program span"
                by[name] = by.get(name, 0.0) + 1e-6 * (b - a)
        return {"idle_s": 1e-6 * _length(idle),
                "under_leaf_s": 1e-6 * _length(_intersect(idle, leaves)), "rest": by}


def read(record: Dict) -> Optional[Spans]:
    """The run's traced slice as ``Spans``, with the program's counters, or
    None without a traced slice.  Read once a run and kept in the record, so
    every metric reads the same trace and the counters are taken once."""
    if not record.get("trace"):
        return None
    if "program_spans" not in record:
        path = TRACE_DIR / "trace.json"
        spans = Spans(json.loads(path.read_text()))
        spans.counters = _take_counters()
        record["program_spans"] = spans
    return record["program_spans"]


def _take_counters() -> Optional[Dict[str, int]]:
    """The program tracer's counters (clearing its buffers), None where the
    program has no tracer."""
    from magma_tpu_torch import observability

    take = getattr(observability, "take", None)
    return take()[1] if take is not None else None

