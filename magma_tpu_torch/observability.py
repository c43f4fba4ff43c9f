"""Observability: profiler traces, step timing, rank-0 metric helpers.

Port of ``magma_tpu/observability.py``:

* ``profile_trace``: a ``torch.profiler`` capture (host ops, and the card's
  kernels when CUDA is available) written as a Chrome trace JSON under the
  log directory, viewable in Perfetto or chrome://tracing,
* ``summarize_trace``: the top device ops of such a trace by total time
  (the host ops when the trace holds no device op, as on the CPU),
* ``StepTimer``: per-step wall time with p50/p95 summaries; it
  synchronises the CUDA device it times before and after each step,
* ``log_table``: wandb.Table when wandb is live, plaintext otherwise
  (parity: magma/utils.py:248-253),
* ``make_grid``: a (b, 3, H, W) batch tiled into one image,
* ``device_memory_stats``: ``torch.cuda.memory_stats`` of each card.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Dict, List, Optional, Sequence

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


class StepTimer:
    """Rolling wall-clock timing of steps: ``with timer: step()``.  On a
    CUDA ``device`` the card is synchronised at both ends, so a step's time
    includes the work it queued."""

    def __init__(self, window: int = 100, device=None):
        self.window = window
        self.device = torch.device(device) if device is not None else None
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._times.append(time.perf_counter() - self._t0)
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def last(self) -> float:
        return self._times[-1] if self._times else float("nan")

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "step_time_p50": float(np.percentile(arr, 50)),
            "step_time_p95": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / np.mean(arr)),
        }


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
