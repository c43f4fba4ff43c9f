"""Faults planted in the program under test, to show that the comparison
that decides ``correct`` catches them (``tests/test_pb_faults.py``, and
``calibrate.py --faults`` on the card).  Each is a context manager that
swaps a program function for a broken one through its module and puts it
back on exit:

* ``token``: every sampled token is altered where it is produced (the
  sampler's id + 1);
* ``top_p_off``: the sampler draws from every logit, ignoring ``top_p``;
* ``temperature_off``: the sampler draws sampled tokens at temperature 1;
* ``stale_cache``: a forward's cache write returns the cache unchanged, so a
  decode step leaves the state as it was;
* ``frozen_step``: the optimizer's step returns the parameters and its
  state unchanged;
* ``half_batch``: a training step takes the first half of its micro-batches
  and the mean over those.
"""

import contextlib
import importlib

from portbench.serve import SAMPLER


@contextlib.contextmanager
def _swap(pairs, make):
    saved = []
    try:
        for module, name in pairs:
            mod = importlib.import_module(module)
            orig = getattr(mod, name)
            saved.append((mod, name, orig))
            setattr(mod, name, make(orig))
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def token():
    def make(orig):
        def broken(*a, **k):
            return (orig(*a, **k) + 1) % 50256
        return broken
    return _swap((SAMPLER,), make)


def _settings(change):
    """The sampler called with its (temperature, top_k, top_p) changed by
    ``change``."""
    def make(orig):
        def broken(generator, logits, **k):
            t, tk, tp = change(k["temperature"], k["top_k"], k["top_p"])
            return orig(generator, logits, **dict(k, temperature=t, top_k=tk, top_p=tp))
        return broken
    return _swap((SAMPLER,), make)


def top_p_off():
    return _settings(lambda t, k, p: (t, k, 0.0))


def temperature_off():
    return _settings(lambda t, k, p: (float(t > 0), k, p))


def stale_cache():
    def make(orig):
        def broken(cache, *a, **k):
            return cache
        return broken
    return _swap((("magma_tpu_torch.models.gptj", "_write_cache"),), make)


def frozen_step():
    def make(orig):
        def broken(self, grads):
            import torch

            return torch.zeros((), dtype=torch.bool, device=self.device)
        return broken
    return _swap_attr("magma_tpu_torch.training.optim", "AdamW", "step", make)


def half_batch():
    def make(orig):
        def broken(self, n, micro_loss):
            return orig(self, max(n // 2, 1), micro_loss)
        return broken
    return _swap_attr("magma_tpu_torch.training.train_loop", "Trainer", "_accumulate_and_step",
                      make)


@contextlib.contextmanager
def _swap_attr(module, cls_name, name, make):
    cls = getattr(importlib.import_module(module), cls_name)
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


FAULTS = {"token": token, "top_p_off": top_p_off, "temperature_off": temperature_off,
          "stale_cache": stale_cache, "frozen_step": frozen_step, "half_batch": half_batch}


@contextlib.contextmanager
def planted(names):
    with contextlib.ExitStack() as stack:
        for n in names:
            stack.enter_context(FAULTS[n]())
        yield
