"""Native (C++) image loader: JPEG/PNG decode + the CLIP preprocess in one
GIL-free C call per image, for the data loader's worker threads.

Port of ``magma_tpu/native/__init__.py`` with its own copy of
``loader.cc``.  The shared library is built lazily on first use with the
system toolchain (``g++ ... -ljpeg -lpng``) into ``build/native/`` at the
repository root, under a name keyed by a hash of the source, never next to
the source.  ``available()`` is False when the toolchain or the headers
are missing, and ``build_error()`` says why; the CLIP transforms then take
the PIL path (``data/transforms.py``), a host decoder as this one is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None

# CLIP normalization constants (reference magma/transforms.py:121-134)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
NO_MEAN = np.zeros(3, np.float32)
NO_STD = np.ones(3, np.float32)


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_loader_{digest}.so"


def _build(so: Path) -> Optional[str]:
    """Compile loader.cc -> ``so``.  Returns an error string or None.  The
    library is written under a process-unique name and moved into place, so
    processes racing the first build never load a half-written file."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp),
           "-ljpeg", "-lpng"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        return f"g++ unavailable: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr[-2000:]
    os.replace(tmp, so)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = library_path()
        if not so.exists():
            err = _build(so)
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _build_error = str(e)
            return None
        lib.mtl_load_clip.restype = ctypes.c_int
        lib.mtl_load_clip.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        lib.mtl_decode.restype = ctypes.c_long
        lib.mtl_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native loader compiled and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    return lib


def load_clip(path, size: int, normalize: bool = True) -> np.ndarray:
    """Decode ``path`` and CLIP-preprocess to (1, 3, size, size) float32.
    Raises IOError on an unreadable or undecodable file (the dataset's
    corrupt-sample fallback catches it like a PIL error)."""
    lib = _lib_or_raise()
    out = np.empty((3, size, size), np.float32)
    mean, std = (CLIP_MEAN, CLIP_STD) if normalize else (NO_MEAN, NO_STD)
    rc = lib.mtl_load_clip(str(path).encode(), size, _fptr(mean), _fptr(std), _fptr(out))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return out[None]


def decode(path) -> np.ndarray:
    """Decode ``path`` to an (h, w, 3) uint8 RGB array.  The first call
    gets a 12 MP buffer; only a larger image pays a second decode at its
    exact size."""
    lib = _lib_or_raise()
    w, h = ctypes.c_int(), ctypes.c_int()
    ptr = ctypes.POINTER(ctypes.c_uint8)
    cap = 12 * 1024 * 1024 * 3
    buf = np.empty(cap, np.uint8)
    need = lib.mtl_decode(str(path).encode(), buf.ctypes.data_as(ptr), cap, ctypes.byref(w),
                          ctypes.byref(h))
    if need < 0:
        raise IOError(f"native decode failed ({need}): {path}")
    if need > cap:
        buf = np.empty(need, np.uint8)
        got = lib.mtl_decode(str(path).encode(), buf.ctypes.data_as(ptr), need,
                             ctypes.byref(w), ctypes.byref(h))
        if got != need:
            raise IOError(f"native decode failed ({got}): {path}")
        return buf.reshape(h.value, w.value, 3)
    return buf[:need].reshape(h.value, w.value, 3).copy()


class NativeClipTransform:
    """Path -> (1, 3, n_px, n_px) float32 numpy, decode included.  Datasets
    see ``wants_path`` and hand it the file's path; a PIL image (a URL
    input) or a format the native decoder does not read (WebP, BMP, CMYK
    JPEG, ...) goes through the host PIL path instead."""

    wants_path = True

    def __init__(self, n_px: int):
        self.n_px = n_px
        self._pil_fallback = None

    def _fallback(self):
        if self._pil_fallback is None:
            from magma_tpu_torch.data.transforms import host_clip_transform

            self._pil_fallback = host_clip_transform(self.n_px)
        return self._pil_fallback

    def __call__(self, path) -> np.ndarray:
        if not isinstance(path, (str, os.PathLike)):
            return self._fallback()(path)
        try:
            return load_clip(path, self.n_px)
        except IOError:
            from PIL import Image

            with Image.open(path) as img:
                return self._fallback()(img.convert("RGB"))
