"""Trainable/frozen parameter partitioning over the port's nested dicts.

Port of ``magma_tpu/parallel/partition.py``: ``partition`` splits a
parameter tree by a boolean mask into a trainable and a frozen tree with
complementary ``None`` leaves; ``combine`` is its inverse.  The Trainer
keeps ``requires_grad`` as its own record of the split; these are the
tree surgery the JAX package's callers use.
"""

from __future__ import annotations

from typing import Tuple

from magma_tpu_torch.utils import tree_map


def partition(params, mask) -> Tuple:
    """(trainable, frozen): the leaves where ``mask`` is True, and the
    others, each with None in the other's places."""
    trainable = tree_map(lambda p, m: p if m else None, params, mask)
    frozen = tree_map(lambda p, m: None if m else p, params, mask)
    return trainable, frozen


def combine(trainable, frozen):
    """Inverse of ``partition``."""
    return tree_map(lambda a, b: a if a is not None else b, trainable, frozen)
