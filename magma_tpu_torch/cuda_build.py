"""Build the port's hand-written CUDA kernels (``csrc/*.cu``) into one shared
library with a plain C interface, and load it with ctypes.

The build runs at first use on a machine with the CUDA toolkit, never at
import.  It goes into ``build/kernels/`` at the repository root, under a
file name keyed by a hash of the sources and flags, so an unchanged tree
reuses the library and a changed one rebuilds.  Only the sources in this
package are compiled.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
# sm_90a keeps Hopper-only instructions (wgmma, setmaxnreg) available;
# -Xptxas=-v reports registers, shared memory and spills in the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already there
    log: str        # nvcc's output (ptxas resource usage), "" when reused


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit "
        "(nvcc on PATH or under CUDA_HOME)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmagma_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile every ``csrc/*.cu`` into one library unless it exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    try:
        failed = [(p.returncode, log) for p, log in zip(procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(log for _, log in failed))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        # atomic install: a concurrent process never loads a half-written file
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return BuildResult(out, time.perf_counter() - t0, "".join(logs))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library (once per process)."""
    return ctypes.CDLL(str(build().path))
