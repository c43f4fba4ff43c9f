"""Small shared utilities: the port of ``magma_tpu/utils.py`` over
``torch.distributed`` (each helper answers for one process when it is not
initialised), and the parameter-tree walks that the JAX package gets from
``jax.tree_util``."""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable, Iterator, Tuple

import torch


def is_main() -> bool:
    """True on rank 0 (or when torch.distributed is not initialised)."""
    return not _distributed() or torch.distributed.get_rank() == 0


def print_main(*msg: Any) -> None:
    """Rank-0-gated print.  Parity: magma/utils.py:21-23."""
    if is_main():
        print(*msg)


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def cycle(loader: Iterable) -> Iterator:
    """Infinite iterator over a re-iterable loader.  Parity: utils.py:37-40."""
    while True:
        for data in loader:
            yield data


def get_world_info() -> Tuple[int, int, int]:
    """(local_rank, rank, world_size) from ``torch.distributed``; (0, 0, 1)
    when it is not initialised.  Parity: magma/utils.py:255-259."""
    if not _distributed():
        return 0, 0, 1
    rank = torch.distributed.get_rank()
    return int(os.environ.get("LOCAL_RANK", rank)), rank, torch.distributed.get_world_size()


_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: str = "cuda") -> Tuple[int, int, int]:
    """Multi-process initialisation (magma/utils.py:262-269; the JAX
    package's ``utils.py:62-75``) from the environment ``torchrun`` sets:
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``.  On the card the backend is NCCL and the rank's device
    ``cuda:LOCAL_RANK`` (``torch.cuda.set_device``); ``device="cpu"`` takes
    gloo.  Without that environment it answers for one process, as the JAX
    package's does; an environment with only some of the variables raises.
    Returns (local_rank, rank, world_size)."""
    if _distributed():
        return get_world_info()
    have = [k for k in _ENV if k in os.environ]
    if not have:
        return 0, 0, 1
    if len(have) < len(_ENV):
        missing = [k for k in _ENV if k not in os.environ]
        raise ValueError(f"torch.distributed environment half set: {missing} missing "
                         f"(have {have}); launch with torchrun")
    local_rank = int(os.environ["LOCAL_RANK"])
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed was asked for the card, but CUDA is not "
                               "available; pass device='cpu' for gloo on the CPU")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    torch.distributed.init_process_group(backend, init_method="env://",
                                         rank=int(os.environ["RANK"]),
                                         world_size=int(os.environ["WORLD_SIZE"]))
    return get_world_info()


def reduce_mean_across_hosts(x: torch.Tensor) -> torch.Tensor:
    """Mean of a scalar tensor over the processes (magma/utils.py:26-34);
    ``x`` itself in one process."""
    if not _distributed() or torch.distributed.get_world_size() == 1:
        return x
    x = x.clone()
    torch.distributed.all_reduce(x)
    return x / torch.distributed.get_world_size()


def tree_size_bytes(params) -> int:
    """Bytes held by the tensors of a parameter tree."""
    return sum(t.numel() * t.element_size() for _, t in tree_items(params))


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


# ---------------------------------------------------------------------------
# Parameter trees: nested dicts and lists of tensors, as in the JAX package
# ---------------------------------------------------------------------------


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in order, the path's keys and list indices joined
    by "/" as the JAX package joins ``tree_map_with_path`` keys
    (e.g. "image_prefix/enc/layer1/0/conv1")."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_paths(tree, prefix: str = ""):
    """A tree of the same structure whose leaves are their "/"-joined paths."""
    if isinstance(tree, dict):
        return {k: tree_paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_paths(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return prefix[:-1]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def count_parameters(params, trainable_mask=None) -> int:
    """Parameters in a tree; with a boolean mask tree of the same
    structure, only the trainable ones.  Parity: magma/utils.py:241-245."""
    leaves = [t for _, t in tree_items(params)]
    if trainable_mask is None:
        return sum(t.numel() for t in leaves)
    mask = [m for _, m in tree_items(trainable_mask)]
    return sum(t.numel() for t, m in zip(leaves, mask) if m)
