"""Small shared utilities: the part of ``magma_tpu/utils.py`` the
caption path uses, without jax."""

from __future__ import annotations

import torch


def is_main() -> bool:
    """True on rank 0 (or when torch.distributed is not initialised)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank() == 0
    return True


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def to_dtype(name_or_dtype) -> torch.dtype:
    """Config dtype name ("bfloat16", ...) or torch.dtype -> torch.dtype."""
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    return DTYPES[name_or_dtype]
