"""Image transforms for the CLIP encoders: PIL image -> CLIP-normalised
(1, 3, n_px, n_px) float32 tensor.

Port of the CLIP part of ``magma_tpu/data/transforms.py`` (reference
magma/transforms.py:121-134).  The PIL image is decoded to uint8 on the
host; resize, crop and normalisation run in ``ops/preprocess.py`` on the
transform's device.  The non-CLIP train-time augmentations are not ported.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from magma_tpu_torch.ops.preprocess import clip_preprocess


def _to_rgb(img):
    return img.convert("RGB") if img.mode != "RGB" else img


def clip_transform(n_px: int, device=None) -> Callable:
    """PIL image -> (1, 3, n_px, n_px) float32 tensor on ``device``
    (center crop; the JAX package's ``use_pad`` variant is not ported)."""

    def fn(img):
        img = _to_rgb(img)
        arr = torch.from_numpy(np.asarray(img, dtype=np.uint8).copy())[None]
        return clip_preprocess(arr.to(device), n_px)

    return fn


def get_transforms(image_size: int, encoder_name: str, input_resolution: int = None,
                   device=None) -> Callable:
    """Transform factory: CLIP encoders use the deterministic CLIP
    preprocess at the encoder's native resolution."""
    if "clip" not in encoder_name:
        raise NotImplementedError(
            f"the train-time transforms for non-CLIP encoders ({encoder_name}) "
            "are not ported yet")
    if input_resolution is None:
        raise ValueError("CLIP transforms need the encoder's input_resolution")
    return clip_transform(input_resolution, device=device)
