"""Bottleneck adapters, functional, over layer-stacked parameter dicts.

Port of ``magma_tpu/models/adapters.py`` (reference magma/adapters.py:6-116):

* ``normal``:          ``f(u) + bottleneck(f(u))``
* ``parallel``:        ``f(u) + bottleneck(u)``
* ``scaled_parallel``: ``f(u) + scale * bottleneck(u)`` with a learned scalar

where ``bottleneck(x) = up(relu(down(maybe_ln(x))))``, initialised
N(0, 1e-3) clamped to +-2 std.  The fused int8 serving payload runs
through ``ops/quant.fused_adapter_stacked`` (K5); the opt-in two-matmul
int8 layout (``gptj._serving_cast_adapters(mode="int8")``) runs each
product through ``_proj`` on K2b.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

ADAPTER_TYPES = ("normal", "parallel", "scaled_parallel")


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Static adapter configuration for one location (mlp or attention)."""

    adapter_type: str = "normal"
    downsample_factor: int = 4
    add_layernorm: bool = False
    init_std: float = 1e-3

    def __post_init__(self):
        if self.adapter_type not in ADAPTER_TYPES:
            raise ValueError(
                f"adapter_type must be one of {ADAPTER_TYPES}, got {self.adapter_type}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "AdapterSpec":
        """From a reference-style dict, e.g. {"adapter_type": "normal",
        "downsample_factor": 4} (configs/MAGMA_v1.yml:4)."""
        d = dict(d)
        return cls(
            adapter_type=d.pop("adapter_type"),
            downsample_factor=d.pop("downsample_factor", 4),
            add_layernorm=d.pop("add_layernorm", False),
            init_std=d.pop("init_std", 1e-3),
        )


def init_adapter(generator: torch.Generator, spec: AdapterSpec, dim: int,
                 n_layers: int, dtype=torch.float32, device=None) -> dict:
    """Adapter params for all layers at once (leading axis = layer)."""
    hidden = dim // spec.downsample_factor
    std = spec.init_std

    def clamped_normal(shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * std
        return w.clamp_(-2 * std, 2 * std).to(dtype)

    params = {
        "down": {
            "kernel": clamped_normal((n_layers, dim, hidden)),
            "bias": clamped_normal((n_layers, hidden)),
        },
        "up": {
            "kernel": clamped_normal((n_layers, hidden, dim)),
            "bias": clamped_normal((n_layers, dim)),
        },
    }
    if spec.add_layernorm:
        params["ln"] = {
            "scale": torch.ones((n_layers, dim), dtype=dtype, device=device),
            "bias": torch.zeros((n_layers, dim), dtype=dtype, device=device),
        }
    if spec.adapter_type == "scaled_parallel":
        params["scale"] = torch.ones((n_layers,), dtype=dtype, device=device)
    return params


def _proj(x: torch.Tensor, kernel, compute_dtype) -> torch.Tensor:
    """A bottleneck product (``adapters.py:98-106``): ``kernel`` is a tensor,
    or a stacked int8 {"q", "s"} pack of the int8 serving mode with its
    layer as "idx" (``gptj._layer_views``), K2b on the card."""
    if isinstance(kernel, dict):
        from magma_tpu_torch.ops.quant import int8_matmul_stacked

        return int8_matmul_stacked(x, kernel["q"], kernel["s"], kernel["idx"],
                                   out_dtype=compute_dtype)
    return x @ kernel.to(compute_dtype)


def _bottleneck(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """up(relu(down(maybe_ln(x)))) for one layer's params."""
    h = x
    if "ln" in params:
        h32 = h.float()
        mean = h32.mean(-1, keepdim=True)
        var = h32.var(-1, keepdim=True, unbiased=False)
        h32 = (h32 - mean) * torch.rsqrt(var + 1e-5)
        h = (h32 * params["ln"]["scale"].float()
             + params["ln"]["bias"].float()).to(compute_dtype)
    down, up = params["down"], params["up"]
    h = torch.relu(_proj(h, down["kernel"], compute_dtype) + down["bias"].to(compute_dtype))
    return _proj(h, up["kernel"], compute_dtype) + up["bias"].to(compute_dtype)


def apply_adapter(
    params: Optional[dict],
    spec: Optional[AdapterSpec],
    branch_in: torch.Tensor,
    branch_out: torch.Tensor,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Combine a block branch output f(u) with its adapter.

    branch_in is the branch input (post-LN u), branch_out the branch output.
    A {"fused": payload, "idx": layer} adapter (the int8 serving layout of
    ``gptj._serving_cast_adapters``) runs as one K5 launch, the
    scaled_parallel scalar already folded into its up scales."""
    if params is None or spec is None:
        return branch_out
    if "fused" in params:
        from magma_tpu_torch.ops.quant import fused_adapter_stacked

        src = branch_out if spec.adapter_type == "normal" else branch_in
        # params["idx"], not .get: a payload that arrives without its layer
        # must fail, not run layer 0's adapter in every layer
        z = fused_adapter_stacked(src, params["fused"], params["idx"],
                                  out_dtype=compute_dtype)
        return branch_out + z
    if spec.adapter_type == "normal":
        return branch_out + _bottleneck(params, branch_out, compute_dtype)
    z = _bottleneck(params, branch_in, compute_dtype)
    if spec.adapter_type == "scaled_parallel":
        z = z * params["scale"].to(compute_dtype)
    return branch_out + z
