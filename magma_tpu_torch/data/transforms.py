"""Image transforms: PIL image (or file path) -> (1, 3, H, W) float32.

Port of ``magma_tpu/data/transforms.py`` (reference magma/transforms.py).
Two pipelines:

* **CLIP encoders** (transforms.py:121-134): bicubic short-side resize,
  center crop (or, with ``use_pad``, pad to a square first), CLIP
  normalisation.  The PIL image is decoded to uint8 on the host and
  ``ops/preprocess.clip_preprocess`` runs on the transform's device: the
  card for the ``Magma`` facade (``get_transforms(..., device=...)``), the
  CPU for the host path the data loader's workers use, where the native
  decoder (``magma_tpu_torch/native``) takes over when it builds.
* **other encoders** (transforms.py:42-84): the random-crop train pipeline
  (``RandCropResize``, optional color jitter, random horizontal flip) at
  ``config.image_size``, on the host.  Its draws come from Python's global
  ``random``, in the JAX package's order, so ``random.seed(s)`` before
  either package's pipeline gives the same array.
"""

from __future__ import annotations

import random
from typing import Callable

import numpy as np
import torch

from magma_tpu_torch.ops.preprocess import clip_preprocess


def _to_rgb(img):
    return img.convert("RGB") if img.mode != "RGB" else img


def _pil_to_uint8(img) -> np.ndarray:
    return np.asarray(_to_rgb(img), dtype=np.uint8)


def _pad_to_square(img, n_px: int):
    """The ``use_pad`` step (transforms.py:94-118): bicubic resize of the
    long side to n_px, pasted centred on a black n_px square."""
    from PIL import Image

    w, h = img.size
    ratio = n_px / max(w, h)
    img = img.resize((max(1, int(w * ratio)), max(1, int(h * ratio))), Image.BICUBIC)
    canvas = Image.new("RGB", (n_px, n_px))
    canvas.paste(img, ((n_px - img.size[0]) // 2, (n_px - img.size[1]) // 2))
    return canvas


def clip_transform(n_px: int, use_pad: bool = False, device=None) -> Callable:
    """PIL image -> (1, 3, n_px, n_px) CLIP-normalised float32 tensor on
    ``device`` (the CPU when None)."""

    def fn(img):
        img = _to_rgb(img)
        if use_pad:
            img = _pad_to_square(img, n_px)
        arr = torch.from_numpy(_pil_to_uint8(img).copy())[None]
        return clip_preprocess(arr.to(device), n_px)

    return fn


def host_clip_transform(n_px: int, use_pad: bool = False) -> Callable:
    """``clip_transform`` on the CPU, returning a numpy array (the data
    loader's PIL path)."""
    fn = clip_transform(n_px, use_pad)
    return lambda img: fn(img).numpy()


class RandCropResize:
    """Random crop -> random resize -> random crop (arXiv:2102.12092's
    augmentations).  Parity: transforms.py:42-61."""

    def __init__(self, target_size: int):
        self.target_size = target_size

    def _pad_to_size(self, img, size):
        from PIL import ImageOps

        dw, dh = size - img.size[0], size - img.size[1]
        if dw <= 0 and dh <= 0:
            return img
        dw, dh = max(dw, 0), max(dh, 0)
        return ImageOps.expand(img, (dw // 2, dh // 2, dw - dw // 2, dh - dh // 2))

    def _random_crop(self, img, size):
        w, h = img.size
        left = random.randint(0, max(0, w - size))
        top = random.randint(0, max(0, h - size))
        return img.crop((left, top, left + size, top + size))

    def __call__(self, img):
        from PIL import Image

        img = self._pad_to_size(img, self.target_size)
        d_min = min(img.size)
        img = self._random_crop(img, d_min)
        t_min = min(d_min, round(9 / 8 * self.target_size))
        t_max = min(d_min, round(12 / 8 * self.target_size))
        t = random.randint(t_min, t_max + 1)
        ratio = t / min(img.size)
        img = img.resize((max(1, round(img.size[0] * ratio)), max(1, round(img.size[1] * ratio))),
                         Image.BICUBIC)
        if min(img.size) < self.target_size:
            ratio = self.target_size / min(img.size)
            img = img.resize((max(self.target_size, round(img.size[0] * ratio)),
                              max(self.target_size, round(img.size[1] * ratio))),
                             Image.BICUBIC)
        return self._random_crop(img, self.target_size)


def color_jitter(arr: np.ndarray, brightness=0.1, contrast=0.1, saturation=0.1,
                 hue=0.05) -> np.ndarray:
    """Random color jitter of a float [0, 1] HWC array (transforms.py:75-76,
    ``T.ColorJitter(0.1, 0.1, 0.1, 0.05)``), as the JAX package does it."""
    b = 1.0 + random.uniform(-brightness, brightness)
    c = 1.0 + random.uniform(-contrast, contrast)
    s = 1.0 + random.uniform(-saturation, saturation)
    h = random.uniform(-hue, hue)

    arr = arr * b
    mean = arr.mean()
    arr = (arr - mean) * c + mean
    gray = arr.mean(axis=-1, keepdims=True)
    arr = (arr - gray) * s + gray
    if h:
        arr = arr + h * (arr[..., [1, 2, 0]] - arr)  # a fractional channel rotation
    return np.clip(arr, 0.0, 1.0)


def train_transform(image_size: int, use_extra_transforms: bool = False) -> Callable:
    """The non-CLIP train pipeline (transforms.py:64-84): RGB, RandCropResize,
    optional color jitter, random horizontal flip -> (1, 3, H, W) float32
    numpy in [0, 1]."""
    rcr = RandCropResize(image_size)

    def fn(img):
        arr = _pil_to_uint8(rcr(_to_rgb(img))).astype(np.float32) / 255.0
        if use_extra_transforms:
            arr = color_jitter(arr)
        if random.random() < 0.5:
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr.transpose(2, 0, 1)[None])

    return fn


def get_transforms(image_size: int, encoder_name: str, input_resolution: int = None,
                   use_extra_transforms: bool = False, native: bool = None,
                   device=None) -> Callable:
    """Transform factory (transforms.py:64-84, magma/magma.py:66-70).

    CLIP encoders take the deterministic CLIP preprocess at the encoder's
    ``input_resolution``: on ``device`` when one is given (the ``Magma``
    facade's default, the preprocess on the card), else on the host:
    the native decoder when it builds (``native`` None or True; True
    raises if it does not build), else PIL and ``clip_preprocess`` on the
    CPU.  Other encoders take the random-crop train pipeline at
    ``image_size``, on the host."""
    if "clip" in encoder_name:
        if input_resolution is None:
            raise ValueError("CLIP transforms need the encoder's input_resolution")
        if device is not None:
            if native:
                raise ValueError("the native decoder is a host path: pass no device")
            return clip_transform(input_resolution, device=device)
        if native is None or native:
            from magma_tpu_torch import native as native_mod

            if native_mod.available():
                return native_mod.NativeClipTransform(input_resolution)
            if native:
                raise RuntimeError(f"native loader unavailable: {native_mod.build_error()}")
        return host_clip_transform(input_resolution)
    return train_transform(image_size, use_extra_transforms)
