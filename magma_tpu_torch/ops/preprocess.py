"""Image preprocessing: bicubic short-side resize, center crop, CLIP
normalisation, on whatever device the images are on.

Port of ``magma_tpu/ops/preprocess.py`` (reference magma/transforms.py:
121-134).  ``F.interpolate(mode="bicubic", antialias=True)`` is the
counterpart of ``jax.image.resize(method="bicubic")``, which antialiases
when it downsamples; without ``antialias`` the two differ by up to 0.36 on
a 480x640 -> 384x512 image.  ``preprocess_uint8_batch`` takes a host
batch to the device first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(images: torch.Tensor, n_px: int, normalize: bool = True) -> torch.Tensor:
    """uint8/float (b, h, w, 3) -> normalised float32 (b, 3, n_px, n_px).

    Integer images are scaled from [0, 255] to [0, 1]; float images pass
    through as they are."""
    _, h, w, _ = images.shape
    x = images.to(torch.float32)
    if not images.dtype.is_floating_point:
        x = x / 255.0
    if h <= w:
        new_h, new_w = n_px, max(n_px, int(round(w * n_px / h)))
    else:
        new_h, new_w = max(n_px, int(round(h * n_px / w))), n_px
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(new_h, new_w), mode="bicubic",
                      align_corners=False, antialias=True)
    top, left = (new_h - n_px) // 2, (new_w - n_px) // 2
    x = x[:, :, top:top + n_px, left:left + n_px]
    if normalize:
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
        x = (x - mean[:, None, None]) / std[:, None, None]
    return x.contiguous()


def preprocess_uint8_batch(images, n_px: int, device="cuda") -> torch.Tensor:
    """A host batch, numpy uint8 (b, h, w, 3), -> normalised float32
    (b, 3, n_px, n_px) on ``device`` (``preprocess.py:63-65``): the card
    unless the caller asks for the CPU, and no CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"preprocess_uint8_batch was asked for {device}, but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return clip_preprocess(torch.from_numpy(np.ascontiguousarray(images)).to(device), n_px)
