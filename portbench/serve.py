"""Shared pieces of the traffic drivers that serve captions: the program's
set-up from the seed (the weights of the cell's language-model family), the
requests' inputs as a client hands them over, the kernel wrappers the
roofline metrics log, the sampler probe and the model FLOPs of a request.

The client side of a request: its uint8 images go through the program's
``preprocess_uint8_batch`` (host to card, resize, crop, normalise), its text
is token ids, and the pieces go to ``Magma.preprocess_inputs`` in order."""

from __future__ import annotations

from typing import Dict, List

QUANT = "magma_tpu_torch.ops.quant"

# the program's kernel wrappers whose launches the roofline metrics cost:
# name -> (module, what a call records); a family adds its own
# (``WRAPPERS``)
INT8_WRAPPERS = {
    "int8_matmul_kernel": (QUANT, lambda a, k: ("k2", a[0].shape[0], a[0].shape[1],
                                                a[1].shape[-1])),
    "int8_matmul_stacked_kernel": (QUANT, lambda a, k: ("k2", a[0].shape[0], a[0].shape[1],
                                                        a[1].shape[-1])),
    "dual_matmul_kernel": (QUANT, lambda a, k: ("k4a", a[0].shape[0], a[0].shape[1],
                                                a[1].shape[1], a[2].shape[-1])),
    "fused_adapter_kernel": (QUANT, lambda a, k: ("k5", a[0].shape[0], a[0].shape[1],
                                                  a[1]["wd"].shape[-1])),
}
# the program's sampler, as ``generate`` calls it through its module
SAMPLER = ("magma_tpu_torch.ops.sampling", "sample_token")


class SamplerProbe:
    """Within the block, one in ``stride`` of the sampled calls of the
    program's sampler (from an offset drawn from the seed) keeps what the
    sampler saw and what it drew: the logits, the settings and the tokens,
    cloned on the device with no wait, and judged after the window by
    ``reference/sampler_ref.py``.  Greedy calls (temperature 0) are not
    counted."""

    def __init__(self, stride: int, seed: int):
        import numpy as np

        self.stride = int(stride)
        self.offset = int(np.random.default_rng([int(seed), 4]).integers(self.stride))
        self.n = 0
        self.kept: List[Dict] = []
        self.saved = None

    def __enter__(self):
        import importlib

        mod = importlib.import_module(SAMPLER[0])
        self.saved = (mod, getattr(mod, SAMPLER[1]))
        setattr(mod, SAMPLER[1], self._shim(self.saved[1]))
        return self

    def _shim(self, orig):
        def shim(generator, logits, **k):
            tok = orig(generator, logits, **k)
            temperature, top_k, top_p = k["temperature"], k["top_k"], k["top_p"]
            if temperature == 0:
                return tok
            self.n += 1
            if (self.n + self.offset) % self.stride == 0:
                self.kept.append({"logits": logits.detach().clone(), "tokens": tok.clone(),
                                  "temperature": temperature, "top_k": top_k, "top_p": top_p,
                                  "vocab_size": k["vocab_size"],
                                  "mode": k.get("top_p_mode", "reference")})
            return tok
        return shim

    def __exit__(self, *exc):
        mod, orig = self.saved
        setattr(mod, SAMPLER[1], orig)
        return False


def setup_model(ctx):
    """The program over the cell's configuration and the seed's weights, in
    its serving layout."""
    from portbench.harness import build_magma

    weights = ctx.cell.family().make_weights(ctx.cell.config["model"], ctx.seed, ctx.device)
    model = build_magma(ctx.cell, weights, ctx.device)
    del weights
    return model


def prompt_inputs(model, req, bank, device) -> List:
    """A request's prompt as the program's entry points take it."""
    from magma_tpu_torch.ops.preprocess import preprocess_uint8_batch

    n_px = model.prefix_config.input_resolution
    out = []
    for kind, v in req.parts:
        if kind == "image":
            out.append(preprocess_uint8_batch(bank[v][None], n_px, device=device))
        else:
            out.append(v[None])
    return out


def sampling_kw(req) -> Dict:
    """The request's sampling as ``generate`` takes it."""
    s = req.sampling
    return {"temperature": float(s.get("temperature", 0.0)),
            "top_k": int(s.get("top_k", 0)), "top_p": float(s.get("top_p", 0.0))}


def image_tokens(model_cfg) -> int:
    return (model_cfg["tower"]["input_resolution"] // 32) ** 2


def request_flops(fam, model_cfg, req, n_tokens: int) -> int:
    """The model FLOPs a finished request required: its images through the
    tower and the projection, its true prompt positions through the LM, and
    each served token after the first (the prefill's) through the LM (the
    LM's counts: the family module ``fam``'s)."""
    from portbench import cost

    s = req.text_len() + image_tokens(model_cfg) * req.n_images()
    flops = req.n_images() * cost.tower_flops(model_cfg["tower"], model_cfg["lm"]["d_model"])
    flops += fam.prompt_flops(model_cfg, s)
    flops += sum(fam.lm_token_flops(model_cfg, s + k + 1) for k in range(max(n_tokens - 1, 0)))
    return flops


def slice_steps(ctx) -> range:
    """The window's steps a traced run profiles (none untraced)."""
    first, n = ctx.cell.params["trace_slice"]
    return range(first, first + n) if ctx.trace else range(0)
