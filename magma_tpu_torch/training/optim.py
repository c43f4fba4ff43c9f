"""The optimizer and learning-rate schedules, written out on tensors.

Port of ``magma_tpu/training/optim.py``, which builds
``optax.apply_if_finite(chain(clip_by_global_norm, multi_transform(
{group: adamw})), max_consecutive_errors=10)``.  The same steps here:

* four parameter groups by path (``label_params``): {main, img_enc} x
  {decay, none}, the image encoder taking ``image_enc_lr`` when set and
  LayerNorms, BatchNorms, embeddings, biases and scales taking no weight
  decay (reference utils.py:120-238);
* DeepSpeed's WarmupLR / WarmupDecayLR as optax's linear and joined
  schedules, evaluated at the count of updates applied so far (so the
  first update takes ``schedule(0)``);
* global-norm clipping (``gradient_clipping``), then AdamW (betas 0.9 /
  0.95, eps 1e-8, decoupled weight decay scaled by the learning rate),
  with the moments kept in each parameter's dtype, as optax keeps them;
* optax's ``apply_if_finite``: a step whose gradients hold a NaN or an
  inf leaves the parameters and the moments (and the counts) as they were,
  unless more than ``max_consecutive_errors`` such steps came in a row.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from magma_tpu_torch import observability as obs
from magma_tpu_torch.config import MultimodalConfig
from magma_tpu_torch.utils import tree_map, tree_paths

BETAS = (0.9, 0.95)
EPS = 1e-8
MAX_CONSECUTIVE_ERRORS = 10


def _f32(value: float, device) -> torch.Tensor:
    """An fp32 scalar on ``device``, made by a fill (no copy from the host,
    so no wait for the card)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _linear(init: float, end: float, steps: int) -> Callable:
    """``optax.linear_schedule`` on a count tensor: fp32 clamp(count, 0,
    steps), 1 - c / steps (a true division: a divisor that is a CPU scalar
    becomes a product with its reciprocal on the card), (init - end) frac +
    end -> an fp32 scalar on the count's device.  An int count is taken as
    a CPU tensor."""
    def f(count) -> torch.Tensor:
        count = torch.as_tensor(count)
        c = count.clamp(0, steps).to(torch.float32)
        frac = 1 - c / _f32(steps, c.device)
        return _f32(init - end, c.device) * frac + _f32(end, c.device)

    return f


def make_schedule(config: MultimodalConfig, base_lr: float) -> Callable:
    """DeepSpeed WarmupLR / WarmupDecayLR (reference config.py:101-123):
    linear warmup min_lr -> lr over ``warmup_num_steps``, then constant, or
    a linear decay to 0 until ``lr_decay_iters``; ``join_schedules`` hands
    the second schedule the count minus the boundary.  Takes the count as a
    tensor (or an int) and returns an fp32 scalar tensor on its device."""
    warmup = _linear(config.min_lr, base_lr, max(config.warmup_num_steps, 1))
    if config.lr_decay_iters is None:
        second = lambda count: _f32(base_lr, count.device)  # noqa: E731
    else:
        second = _linear(base_lr, 0.0,
                         max(config.lr_decay_iters - config.warmup_num_steps, 1))
    boundary = config.warmup_num_steps

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count)
        return torch.where(count < boundary, warmup(count), second(count - boundary))

    return schedule


def _no_decay(path: str) -> bool:
    """Weight-decay blacklist (utils.py:120-161): layernorms, embeddings,
    biases; adapter ``scale`` scalars and BN params too."""
    parts = path.split("/")
    leaf = parts[-1]
    if leaf in ("bias", "scale"):
        return True
    if any(p.startswith("ln") or p.startswith("bn") or p == "down_bn" for p in parts):
        return True
    return leaf in ("wte", "pos_embed", "class_token", "skipinit_gain", "gain")


def _label(path: str) -> str:
    group = "img_enc" if path.startswith("image_prefix/enc") else "main"
    return f"{group}_{'none' if _no_decay(path) else 'decay'}"


def label_params(params) -> Dict:
    """A tree of group labels: "{main,img_enc}_{decay,none}" by path."""
    return tree_map(lambda _, path: _label(path), params, tree_paths(params))


class AdamW:
    """The JAX package's optimizer over the trainable tensors, given as
    (path, tensor) pairs.  ``step(grads)`` updates the tensors in place
    from gradients in their dtypes and returns whether the update was
    applied, as a bool tensor on the parameters' device.  Every decision of
    a step stays on that device, as in the JAX package's jitted step: the
    finite flag, the clip, the applied flag and the counts (int32 tensors)
    select through ``torch.where``, so the host never waits for the card.
    ``state_dict``/``load_state_dict`` carry the moments and counts (the
    checkpoint's ``opt_state``, counts as Python ints)."""

    def __init__(self, config: MultimodalConfig, named_params: List):
        self.paths = [p for p, _ in named_params]
        self.params = [t for _, t in named_params]
        self.device = self.params[0].device if self.params else torch.device("cpu")
        main = make_schedule(config, config.lr)
        enc = make_schedule(config, config.image_enc_lr if config.image_enc_lr is not None
                            else config.lr)
        labels = [_label(p) for p in self.paths]
        self.lr = [enc if lb.startswith("img_enc") else main for lb in labels]
        self.wd = [0.0 if lb.endswith("none") else config.weight_decay for lb in labels]
        self.clip = config.gradient_clipping if config.gradient_clipping else 0.0
        self.mu = [torch.zeros_like(t) for t in self.params]
        self.nu = [torch.zeros_like(t) for t in self.params]
        self._set_counts(0, 0, 0)

    def _set_counts(self, count: int, notfinite: int, total: int) -> None:
        def i32(v):
            return torch.full((), v, dtype=torch.int32, device=self.device)

        self.count = i32(count)              # updates applied (Adam's and the schedules')
        self.notfinite_count = i32(notfinite)  # consecutive non-finite steps
        self.total_notfinite = i32(total)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        obs.count("optim.tensors", len(grads))
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        self.notfinite_count = torch.where(finite, 0, self.notfinite_count + 1)
        self.total_notfinite = torch.where(finite, self.total_notfinite,
                                           self.total_notfinite + 1)
        applied = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)
        if self.clip > 0:  # optax.clip_by_global_norm
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.clip
            grads = [torch.where(keep, g, (g / norm.to(g.dtype)) * self.clip) for g in grads]
        b1, b2 = BETAS
        count = self.count + 1
        # the step's scalars, made once for each (dtype, device) and schedule
        bias_corr, neg_lr = {}, {}
        for i, (p, g) in enumerate(zip(self.params, grads)):
            dt, key = p.dtype, (p.dtype, p.device)
            mu = (1 - b1) * g + b1 * self.mu[i]
            nu = (1 - b2) * (g * g) + b2 * self.nu[i]
            if key not in bias_corr:  # in fp32, then in the moment's dtype
                bias_corr[key] = [(1 - _f32(b, p.device) ** count.to(p.device)).to(dt)
                                  for b in BETAS]
            bc1, bc2 = bias_corr[key]
            if (self.lr[i], key) not in neg_lr:
                neg_lr[self.lr[i], key] = (-self.lr[i](self.count.to(p.device))).to(dt)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            u = u + self.wd[i] * p
            u = neg_lr[self.lr[i], key] * u
            self.mu[i] = torch.where(applied, mu, self.mu[i])
            self.nu[i] = torch.where(applied, nu, self.nu[i])
            p.copy_(torch.where(applied, (p + u).to(dt), p))
        self.count = torch.where(applied, count, self.count)
        return applied

    def state_dict(self) -> Dict:
        return {"mu": dict(zip(self.paths, self.mu)), "nu": dict(zip(self.paths, self.nu)),
                "count": int(self.count), "notfinite_count": int(self.notfinite_count),
                "total_notfinite": int(self.total_notfinite)}

    def load_state_dict(self, state: Dict) -> None:
        for i, (path, t) in enumerate(zip(self.paths, self.params)):
            self.mu[i] = state["mu"][path].to(device=t.device, dtype=t.dtype)
            self.nu[i] = state["nu"][path].to(device=t.device, dtype=t.dtype)
        self._set_counts(int(state["count"]), int(state["notfinite_count"]),
                         int(state["total_notfinite"]))
