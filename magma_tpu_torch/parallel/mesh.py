"""The process mesh: ranks laid out over named axes, one process group per
line along each set of axes, and the collectives the model's parallel
layers call.

Port of ``magma_tpu/parallel/mesh.py``.  The JAX package builds one
``jax.sharding.Mesh`` over the devices of one program and lets GSPMD
insert the collectives; the port runs one process per rank (as the
reference MAGMA ran under DeepSpeed) and calls ``torch.distributed``
itself.  The layout is JAX's: ``np.arange(world).reshape(dp, tp[, sp])``,
sp innermost, so rank r sits where JAX's device r sits.

A world of one process without ``init_process_group`` is a mesh of size 1
whose collectives are the identity.  Once ``torch.distributed`` is
initialised every axis gets its groups, a size-1 axis included, and every
collective is called, so a world of 1 runs the same code as a larger one.

The collectives take and return tensors on the caller's device: the
model's layers call ``all_reduce``, ``broadcast`` and
``all_gather_into_tensor`` (the vocab-sharded head's logits, checkpoints'
tp shards), and the ring its send/recv (``parallel/ring_attention.py``).
The autograd pairs of Megatron's tensor parallelism are here too: ``copy_to``
(identity forward, all_reduce backward) at a column-parallel input and
``reduce_from`` (all_reduce forward, identity backward) at a row-parallel
output.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def mesh_layout(n: int, dp: int = -1, tp: int = 1, sp: int = 1) -> np.ndarray:
    """The ranks 0..n-1 laid out as JAX lays out its devices
    (``mesh.py:20-47``): (dp, tp), or (dp, tp, sp) when sp > 1.  dp == -1
    takes the remaining ranks.  Raises ValueError where JAX asserts."""
    if dp == -1:
        if n % (tp * sp):
            raise ValueError(f"{n} ranks not divisible by tp*sp={tp * sp}")
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) * sp({sp}) != ranks({n})")
    shape = (dp, tp) if sp == 1 else (dp, tp, sp)
    return np.arange(n).reshape(shape)


class Mesh:
    """This process's place in a rank layout: ``axis_names``, ``shape`` (a
    dict, as JAX's), ``axis_index(name)``, ``size(name)`` and the process
    group of the line through this rank along any set of axes
    (``group(axes)``; None when torch.distributed is not initialised)."""

    def __init__(self, layout: np.ndarray, axis_names: Sequence[str], rank: int,
                 global_ranks: Sequence[int], groups: Dict[Tuple[str, ...], object]):
        self.devices = layout            # positions in ``global_ranks``
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, layout.shape))
        self.global_ranks = list(global_ranks)
        self.rank = rank                 # this process's global rank
        pos = self.global_ranks.index(rank)
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.argwhere(layout == pos)[0])))
        self._groups = groups

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    @property
    def distributed(self) -> bool:
        """True when the mesh has process groups (torch.distributed is
        initialised), whatever its size."""
        return bool(self._groups)

    def axis_index(self, name: str) -> int:
        return self.coords[name] if name in self.coords else 0

    def size(self, axes: Axes) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in _axes(axes)]))

    def line(self, axes: Axes) -> list:
        """The global ranks of the line through this rank along ``axes``,
        in the layout's order (the axes' own order, the last innermost)."""
        axes = tuple(a for a in _axes(axes) if a in self.shape)
        index = tuple(slice(None) if n in axes else self.coords[n] for n in self.axis_names)
        return [self.global_ranks[int(p)] for p in self.devices[index].reshape(-1)]

    def line_rank(self, axes: Axes) -> int:
        """This rank's position on its line along ``axes``."""
        return self.line(axes).index(self.rank)

    def group(self, axes: Axes):
        return self._groups.get(tuple(a for a in _axes(axes) if a in self.shape))


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A ("dp", "tp") mesh, or ("dp", "tp", "sp") with sp > 1 (sp innermost:
    a ring's neighbours are neighbouring ranks), over ``ranks`` (default
    every rank of the initialised world; one rank when torch.distributed is
    not initialised).  Every rank of the world must call this with the same
    arguments (``mesh_from_layout``)."""
    n = len(ranks) if ranks is not None else (
        dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1)
    layout = mesh_layout(n, dp, tp, sp)
    return mesh_from_layout(layout, ("dp", "tp") if layout.ndim == 2 else ("dp", "tp", "sp"),
                            ranks)


def mesh_from_layout(layout: np.ndarray, names: Sequence[str],
                     ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of an explicit layout (positions 0..n-1 into ``ranks``) and
    axis names; ``make_mesh`` builds JAX's layouts through it, and a caller
    may name a size-1 axis JAX's ``make_mesh`` leaves out (a ring over one
    rank).  ``dist.new_group`` is collective: every process makes every
    group of every line along every set of axes, in one order, and keeps
    its own."""
    names = tuple(names)
    initialised = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if initialised else 0
    if ranks is None:
        ranks = list(range(dist.get_world_size() if initialised else 1))
    ranks = list(ranks)
    if layout.size != len(ranks):
        raise ValueError(f"a layout of {layout.size} positions over {len(ranks)} ranks")
    if len(ranks) > 1 and not initialised:
        raise ValueError(f"a mesh over {len(ranks)} ranks needs torch.distributed "
                         "initialised (utils.init_distributed)")
    groups: Dict[Tuple[str, ...], object] = {}
    if initialised:
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                keep = [i for i, n in enumerate(names) if n in axes]
                rest = [i for i in range(len(names)) if i not in keep]
                lines = np.transpose(layout, rest + keep).reshape(-1, int(
                    np.prod([layout.shape[i] for i in keep])))
                for line in lines:
                    members = [ranks[int(p)] for p in line]
                    g = dist.new_group(members)
                    if rank in members:
                        groups[axes] = g
    return Mesh(layout, names, rank, ranks, groups)


# ---------------------------------------------------------------------------
# Collectives over a mesh axis (identity where there is no group)
# ---------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh: Optional[Mesh], axes: Axes,
               op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the line along ``axes`` (in place when reduced);
    ``t`` itself without a group."""
    g = None if mesh is None else mesh.group(axes)
    if g is None:
        return t
    dist.all_reduce(t, op=_OPS[op], group=g)
    return t


def broadcast(t: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    """``t`` of the first rank on the line along ``axes``, on every rank of
    it (in place)."""
    g = None if mesh is None else mesh.group(axes)
    if g is None:
        return t
    dist.broadcast(t, src=mesh.line(axes)[0], group=g)
    return t


def gather_last(t: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """The line's shards concatenated along the last dim, in line order
    (one ``all_gather_into_tensor``, whose slots follow the group's ranks)."""
    g = None if mesh is None else mesh.group(axis)
    if g is None:
        return t
    line = mesh.line(axis)
    out = t.new_empty(len(line) * t.numel())  # flat: gloo takes the concatenated form
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1), group=g)
    out = out.view(len(line), *t.shape)
    order = [dist.get_process_group_ranks(g).index(r) for r in line]
    if order != sorted(order):
        out = out[order]
    return out.movedim(0, -2).reshape(*t.shape[:-1], len(line) * t.shape[-1])


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x.contiguous().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes), None, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.lo = mesh.line_rank(axis) * x.shape[-1]
        ctx.w = x.shape[-1]
        return gather_last(x.contiguous(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.w], None, None


def _active(mesh: Optional[Mesh], axes: Axes) -> bool:
    return mesh is not None and mesh.group(axes) is not None


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    """A replicated activation entering a column-parallel product: identity
    forward, the gradient summed over the line backward."""
    return _CopyTo.apply(x, mesh, axes) if _active(mesh, axes) else x


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    """A row-parallel product's partial sums: summed over the line forward,
    the gradient passed through backward."""
    return _ReduceFrom.apply(x, mesh, axes) if _active(mesh, axes) else x


def sum_both(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    """A sum over the line whose every rank's loss depends on every term
    (BatchNorm's batch statistics over dp): summed forward and backward."""
    return _SumBoth.apply(x, mesh, axes) if _active(mesh, axes) else x


def gather_from(x: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """Shards of the last dim gathered forward (``gather_last``); backward
    each rank keeps its own slice of the (replicated) gradient."""
    return _GatherLast.apply(x, mesh, axis) if _active(mesh, axis) else x
