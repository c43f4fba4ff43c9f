"""Sharding rules: each parameter's spec by its tree path, and this rank's
slice of a tensor under a spec.

Port of ``magma_tpu/parallel/sharding.py``.  The rules are the JAX
package's, string for string; a spec is a tuple of mesh axis names or
None, one per dim (JAX's ``PartitionSpec``).  Where JAX places a global
array on the mesh, the port keeps only this rank's contiguous slice
(``shard_tensor``): the model's parallel layers (``models/gptj.py``) then
run on local shards and call the collectives of ``parallel/mesh.py``.

LM rules (leading axis L is the layer stack):
  wte            (V, D)      -> ("tp", None)        vocab-sharded embedding
  attn q/k/v     (L, D, D)   -> (None, None, "tp")  head-sharded columns
  attn o         (L, D, D)   -> (None, "tp", None)  row-sharded (summed out)
  mlp fc_in      (L, D, F)   -> (None, None, "tp")  column-parallel
  mlp fc_out     (L, F, D)   -> (None, "tp", None)  row-parallel
  lm_head_q      (D, V)      -> (None, "tp")        vocab-sharded head
  LN, adapters, o_bias, the fc_out bias, the vision tower: replicated.

One step the JAX package does not need: the int8 head's shard (50304 / tp
columns: 25152 at tp 2, 12576 at tp 4) is padded with zero columns to a
multiple of 128, the width K2a takes (``ops/quant.py`` KERNEL_ALIGN);
``gptj.lm_head`` cuts the padding off before it gathers the logits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from magma_tpu_torch.parallel.mesh import Mesh, gather_last
from magma_tpu_torch.utils import tree_map, tree_paths

Spec = Tuple[Optional[str], ...]

HEAD_ALIGN = 128  # K2a's column alignment (ops/quant.py KERNEL_ALIGN)


def _raw_lm_spec(path: str) -> Spec:
    """Spec for a raw (unquantized) LM weight path."""
    if path.endswith("wte"):
        return ("tp", None)
    if "adapter" in path:
        return ()  # adapters are tiny; replicate
    if path.endswith("lm_head_q"):
        return (None, "tp")  # (D, padded_vocab): vocab-sharded head
    if "/attn/" in path:
        if path.endswith(("/q", "/k", "/v", "/qkv", "/in_proj")):
            return (None, None, "tp")
        if path.endswith("/o"):
            return (None, "tp", None)
        return ()  # o_bias
    if "/mlp/fc_in/kernel" in path:
        return (None, None, "tp")
    if "/mlp/fc_in/bias" in path:
        return (None, "tp")
    if "/mlp/fc_out/kernel" in path:
        return (None, "tp", None)
    return ()  # ln_1, ln_f, fc_out bias, anything else: replicated


def lm_param_spec(path: str, ndim: int) -> Spec:
    """Spec for one LM parameter, by path substring.  A quantized weight is
    a {"q": int8 kernel, "s": per-out-channel scales} pair: the payload
    takes the kernel's spec, the scales the kernel's spec without its
    contraction (second-to-last) axis.  A raw attention "q" projection
    ("attn/q") keeps its own rule."""
    if path.endswith(("/q", "/s")) and not path.endswith(("attn/q", "attn/s")):
        kernel_spec = _raw_lm_spec(path[:-2])
        if path.endswith("/q"):
            return kernel_spec
        axes = list(kernel_spec)
        if len(axes) >= 2:
            axes.pop(-2)  # drop the contraction-dim entry
        return tuple(axes)
    return _raw_lm_spec(path)


def param_spec(path: str, ndim: int) -> Spec:
    if path.startswith("lm"):
        return lm_param_spec(path, ndim)
    return ()  # image prefix + encoder: replicated


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` under ``spec``: each dim named
    by an axis of size n is cut into n equal parts and the part at this
    rank's index on that axis kept."""
    out = t
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        n = mesh.size(axis)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} is not divisible by "
                             f"{axis}={n}")
        w = out.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(axis) * w, w)
    return out.contiguous() if out is not t else t


def _pad_head(path: str, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A vocab shard of the int8 head, zero-padded to HEAD_ALIGN columns."""
    if mesh.size("tp") > 1 and path.endswith(("lm_head_q/q", "lm_head_q/s")):
        pad = (-t.shape[-1]) % HEAD_ALIGN
        if pad:
            t = F.pad(t, (0, pad))
    return t


def shard_params(mesh: Mesh, params):
    """This rank's slices of a full parameter tree ({"lm", "image_prefix"}),
    each leaf by ``param_spec``."""
    return tree_map(lambda t, path: _pad_head(path, shard_tensor(t, param_spec(path, t.dim()),
                                                                 mesh), mesh),
                    params, tree_paths(params))


def shard_lm_params(mesh: Mesh, lm_params):
    """This rank's slices of a bare LM tree (no "lm/" prefix), the serving
    engine's layout: Megatron's tensor-parallel shards, the int8 head's
    shard padded (module docstring)."""
    return tree_map(
        lambda t, path: _pad_head(path, shard_tensor(t, lm_param_spec("lm/" + path, t.dim()),
                                                     mesh), mesh),
        lm_params, tree_paths(lm_params))


def _gather_dim(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    return gather_last(t.movedim(dim, -1).contiguous(), mesh, axis).movedim(-1, dim)


def unshard_params(mesh: Mesh, params, lm_cfg):
    """The full tree from this rank's shards (``shard_params``' inverse): each
    sharded leaf gathered over its axes, the int8 head's padding cut off
    first.  Every rank of the line must call it.  ``params`` itself when
    nothing is sharded."""
    if mesh.size("tp") == 1:
        return params

    def full(t, path):
        spec = param_spec(path, t.dim())
        if path.endswith(("lm_head_q/q", "lm_head_q/s")):
            t = t[..., :lm_cfg.padded_vocab_size // mesh.size("tp")]
        for dim, axis in enumerate(spec):
            if axis is not None and mesh.size(axis) > 1:
                t = _gather_dim(t, mesh, axis, dim)
        return t

    return tree_map(full, params, tree_paths(params))


def kv_cache_spec(name: str) -> Spec:
    """Spec for one KV-cache entry: K/V (L, b, max_len, h, hd) shard over
    heads (as the head-sharded q/k/v projections); the position-minor int8
    scales (L, b, h, max_len) on their h axis."""
    if name.endswith("_scale"):
        return (None, None, "tp", None)
    return (None, None, None, "tp", None)


def shard_kv_cache(mesh: Mesh, cache: Dict) -> Dict:
    """This rank's head shard of a ``gptj.init_kv_cache`` dict."""
    return {name: shard_tensor(v, kv_cache_spec(name), mesh) for name, v in cache.items()}


def shard_batch(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's "dp" slice of a global batch along ``dim``: ("dp",) for a
    flat batch (JAX's ``batch_sharding``), dim 1 for the Trainer's (ga,
    micro_b, ...) layout (``P(None, "dp")``)."""
    spec = (None,) * dim + ("dp",)
    return shard_tensor(t, spec, mesh)
