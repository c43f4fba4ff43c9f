"""Observability: profiler traces, the program's spans and counters, rank-0
metric helpers.

Port of ``magma_tpu/observability.py``:

* ``profile_trace``: a ``torch.profiler`` capture (host ops, and the card's
  kernels when CUDA is available) written as a Chrome trace JSON under the
  log directory, viewable in Perfetto or chrome://tracing,
* ``summarize_trace``: the top device ops of such a trace by total time
  (the host ops when the trace holds no device op, as on the CPU),
* ``span``, ``count``, ``tracing``, ``take``, ``export_chrome_trace``: the
  program's own tracer (below),
* ``log_table``: wandb.Table when wandb is live, plaintext otherwise
  (parity: magma/utils.py:248-253),
* ``make_grid``: a (b, 3, H, W) batch tiled into one image,
* ``device_memory_stats``: ``torch.cuda.memory_stats`` of each card.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from magma_tpu_torch.utils import is_main

# Chrome-trace categories of the ops that run on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``with profile_trace("dir"): step()`` records the block with
    ``torch.profiler`` and writes ``dir/trace_<ns>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


# ---------------------------------------------------------------------------
# The program's spans and counters
# ---------------------------------------------------------------------------
# Tracing is on while a torch.profiler capture records, or inside ``with
# tracing():``; otherwise ``span`` returns one shared no-op object after that
# check (~0.1 us) and ``count`` returns at once.  A span enters
# ``record_function`` only while a profiler records (even with the profiler
# off one costs microseconds): there it lies on the kernels' timeline in the
# profiler's trace.  Spans and counters stay in memory until ``take``.  The
# timestamps are ``time.time_ns()``, the epoch clock of the profiler's Chrome
# trace (an event starts at ``baseTimeNanoseconds + ts * 1000`` ns).

MAX_SPANS = 1 << 18  # kept until take(); past it "trace.dropped" counts the rest


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the enclosing span on this thread
    root: int              # the outermost enclosing span: shared by one request or step
    attrs: Dict
    thread: int            # the OS thread id, as the profiler's trace gives it


class _Tracer:
    """The process's tracing depth, kept spans and counters."""

    def __init__(self):
        self.depth = 0
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def thread(self) -> Tuple[List, int]:
        """This thread's stack of open spans and its OS thread id (read once:
        reading it is a system call)."""
        th = getattr(self.local, "th", None)
        if th is None:
            th = self.local.th = ([], threading.get_native_id())
        return th

    def add(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def keep(self, s: Span) -> None:
        if len(self.spans) < MAX_SPANS:
            self.spans.append(s)
        else:
            self.add("trace.dropped", 1)


_TRACER = _Tracer()
_profiling = torch._C._autograd._profiler_enabled


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start", "rf", "stack", "tid")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.stack, self.tid = _TRACER.thread()
        top = self.stack[-1] if self.stack else None
        self.id = next(_TRACER.ids)
        self.parent = top.id if top is not None else None
        self.root = top.root if top is not None else self.id
        self.stack.append(self)
        self.rf = None
        if _profiling():
            from torch.profiler import record_function

            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        _TRACER.keep(Span(self.name, self.start, end, self.id, self.parent, self.root,
                          self.attrs, self.tid))
        return False


def enabled() -> bool:
    """Whether spans and counters are recorded now."""
    return bool(_TRACER.depth) or _profiling()


def span(name: str, **attrs):
    """``with span("lm.prefill", positions=s):`` records the block as a span
    (name, start, end, its id, its parent's and its root's, ``attrs``) while
    tracing is on; a shared no-op otherwise."""
    if _TRACER.depth or _profiling():
        return _Span(name, attrs)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on.  ``n`` is a host
    integer: a counter never reads from the card, so a tensor is refused."""
    if not (_TRACER.depth or _profiling()):
        return
    if isinstance(n, torch.Tensor):
        raise TypeError(f"counter {name!r} takes a host integer, got a tensor")
    _TRACER.add(name, int(n))


@contextlib.contextmanager
def tracing():
    """Spans and counters are recorded inside the block, with no profiler."""
    with _TRACER.lock:
        _TRACER.depth += 1
    try:
        yield
    finally:
        with _TRACER.lock:
            _TRACER.depth -= 1


def take() -> Tuple[List[Span], Dict[str, int]]:
    """The spans (in the order they ended) and counters kept so far; clears
    both."""
    with _TRACER.lock:
        spans, counters = _TRACER.spans, _TRACER.counters
        _TRACER.spans, _TRACER.counters = [], {}
    return spans, counters


def export_chrome_trace(path: str, spans: Sequence[Span], counters: Dict[str, int]) -> None:
    """Write ``spans`` as Chrome-trace complete ("X") events and ``counters``
    as counter ("C") events at the last span's end, in us on the epoch clock
    (a profiler trace's events are on it after adding its
    ``baseTimeNanoseconds`` / 1000), for Perfetto or chrome://tracing."""
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "cat": "span", "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": s.thread,
               "args": dict(s.attrs, id=s.id, parent=s.parent, root=s.root)} for s in spans]
    at = max((s.end_ns for s in spans), default=time.time_ns()) / 1e3
    events += [{"name": k, "ph": "C", "ts": at, "pid": pid, "args": {k: v}}
               for k, v in sorted(counters.items())]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def log_table(name: str, model_outputs: Sequence[str], gt_answers_list: Sequence,
              global_step: int, wandb_module=None) -> None:
    """Eval answers table (parity: utils.py:248-253), wandb optional."""
    if not is_main():
        return
    if wandb_module is not None:
        table = wandb_module.Table(columns=["model output", "ground truth(s)"])
        for o, gt in zip(model_outputs, gt_answers_list):
            table.add_data(o, gt)
        wandb_module.log({f"eval/{name}": table}, step=global_step)
        return
    print(f"[eval/{name} @ step {global_step}]")
    for o, gt in zip(model_outputs, gt_answers_list):
        print(f"  output: {o!r}  |  gt: {gt!r}")


def make_grid(images, pad: int = 2) -> np.ndarray:
    """Tile a (b, 3, H, W) batch (numpy or a tensor) into one (3, H', W')
    numpy image (parity: torchvision.utils.make_grid at train_loop.py:93)."""
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().numpy()
    images = np.asarray(images)
    b, c, h, w = images.shape
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    grid = np.zeros((c, rows * (h + pad) + pad, cols * (w + pad) + pad), images.dtype)
    for i in range(b):
        r, col = divmod(i, cols)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[:, y:y + h, x:x + w] = images[i]
    return grid


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Each card's memory in GiB: in use and peak by the caching allocator
    (``torch.cuda.memory_stats``) and the card's total; {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gib": s.get("allocated_bytes.all.current", 0) / 2**30,
            "peak_bytes_in_use_gib": s.get("allocated_bytes.all.peak", 0) / 2**30,
            "bytes_limit_gib": torch.cuda.get_device_properties(i).total_memory / 2**30,
        }
    return out


def summarize_trace(logdir: str, top: int = 20) -> List[Dict[str, object]]:
    """Aggregate the ``profile_trace`` captures under ``logdir`` into op
    totals: the ``top`` device ops (kernels, copies, memsets) by total
    duration, or the host ops when the traces hold no device op.  Rows
    ``{"plane", "line", "op", "total_ms", "count"}``, sorted descending;
    ``plane`` is "device" or "host" and ``line`` the stream or thread."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no trace json under {logdir}")
    events = []
    for path in paths:
        with open(path) as f:
            events += [e for e in json.load(f).get("traceEvents", [])
                       if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    plane, chosen = ("device", device) if device else (
        "host", [e for e in events if e.get("cat") == "cpu_op"])
    agg: Dict[tuple, float] = {}
    cnt: Dict[tuple, int] = {}
    for e in chosen:
        key = (str(e.get("tid")), e["name"])
        agg[key] = agg.get(key, 0.0) + float(e["dur"]) / 1e3
        cnt[key] = cnt.get(key, 0) + 1
    rows = [{"plane": plane, "line": k[0], "op": k[1], "total_ms": round(v, 4),
             "count": cnt[k]} for k, v in agg.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:top]
