"""The traced slice: ``torch.profiler`` over a bounded part of the window,
reduced here to device busy time, kernel time by name, idle gaps named by
what the host was doing, and the launches of the kernel wrappers the
roofline metrics read.

The host annotates its own work with ``span(name)`` (``record_function``
ranges named ``pb.<name>``); an idle gap on the device takes the name of
the innermost such range open at its midpoint.  Wrapper calls are logged by
swapping the program's module-level kernel wrappers for counting shims
within the slice (the program calls them through their modules)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

TRACE_DIR = Path("build") / "portbench"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host range the trace can name idle gaps by (free when untraced:
    ``record_function`` records only under an active profiler)."""
    from torch.profiler import record_function

    return record_function("pb." + name)


class WrapperLog:
    """Within the block, every call of the named program functions is logged
    through its extractor, ``extract(args, kwargs) -> tuple``, which reads
    shapes without a device wait (a tensor whose value is needed is cloned
    on the device and read after the block)."""

    def __init__(self, wrappers: Optional[Dict] = None):
        self.wrappers = wrappers or {}  # name -> (module path, extractor)
        self.calls: List = []
        self.saved = {}

    def __enter__(self):
        import importlib

        for name, (module, extract) in self.wrappers.items():
            mod = importlib.import_module(module)
            orig = getattr(mod, name)
            self.saved[name] = (mod, orig)
            setattr(mod, name, self._shim(orig, extract))
        return self

    def _shim(self, orig, extract):
        def shim(*args, **kwargs):
            self.calls.append(extract(args, kwargs))
            return orig(*args, **kwargs)

        shim.__dict__.update(orig.__dict__)  # the counters the program bumps
        return shim

    def __exit__(self, *exc):
        for name, (mod, orig) in self.saved.items():
            orig.__dict__.update(getattr(mod, name).__dict__)  # what it counted meanwhile
            setattr(mod, name, orig)
        self.saved = {}
        return False


class Slice:
    """``with Slice(log_wrappers) as s:`` profiles the block; ``s.summary``
    then holds the reduced trace."""

    def __init__(self, wrappers: Optional[Dict] = None, name: str = "slice"):
        self.log = WrapperLog(wrappers)
        self.name = name
        self.summary: Dict = {}
        self.open = False

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.rf = span(self.name)
        self.rf.__enter__()
        self.log.__enter__()
        self.open = True
        return self

    def __exit__(self, *exc):
        import torch

        if not self.open:
            return False
        self.open = False
        self.log.__exit__(*exc)
        torch.cuda.synchronize()
        self.rf.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> Dict:
        """The slice's summary, read from the profiler's trace (after the
        window, so that writing and reading the trace costs it nothing)."""
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / "trace.json"
        self.prof.export_chrome_trace(str(path))
        self.summary = reduce_trace(json.loads(path.read_text()), "pb." + self.name)
        self.summary["calls"] = self.log.calls
        self.prof = None
        return self.summary


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(trace: Dict, slice_name: str) -> Dict:
    """A chrome trace -> {"window_s", "busy_s", "kernels": {name: [seconds
    each launch]}, "idle_gaps": {host range: seconds}}, all within the
    slice's own host range.  Device intervals are clipped to it."""
    events = trace.get("traceEvents", trace)
    rng = [e for e in events if e.get("name") == slice_name and e.get("ph") == "X"]
    if not rng:
        raise RuntimeError(f"the trace has no {slice_name} range")
    t0, t1 = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
    dev, kernels = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        dev.append((a, b))
        kernels.setdefault(e["name"], []).append((b - a) * 1e-6)
    busy = _merge(dev)
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][3:]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("pb.") and e["name"] != slice_name),
                   key=lambda s: s[0])
    gaps: Dict[str, float] = {}
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "other host work"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": kernels, "idle_gaps": gaps}


def breakdown(summary: Dict) -> Dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten host ranges with the most idle device time."""
    ops = sorted(((n[:160], sum(t)) for n, t in summary["kernels"].items()),
                 key=lambda x: -x[1])[:10]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": [[n, t] for n, t in gaps]}
