"""The plain reference against the port's CPU path at a tiny size, in
float32: the vision prefix, the LM's logits (full precision and the int8
serving layout), and a training step's loss, gradients and BatchNorm
statistics.  (The test may import both; the reference imports nothing of
the port.)"""

import json

import numpy as np
import pytest
import torch

from conftest import HERE
from portbench.feed import batch
from portbench.mix import image_bank, make_requests
from portbench.reference import magma_ref, train_ref
from portbench.weights import make_weights


def _config(name):
    """A tiny configuration computed in float32 (the LM and the tower)."""
    c = json.loads((HERE / "data" / "configs" / f"{name}.json").read_text())
    c["yml"]["compute_dtype"] = "float32"
    c["yml"]["encoder_overrides"] = dict(c["yml"]["encoder_overrides"], compute_dtype="float32")
    return c


def _magma(cfg, weights):
    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.models.magma import Magma

    m = Magma(MultimodalConfig(**cfg["yml"]), device="cpu", init_weights=False)
    m.params = {"lm": weights["lm"], "image_prefix": weights["image_prefix"]}
    m.state = {"image_prefix": weights["stats"]}
    return m


@pytest.fixture(scope="module")
def served():
    """The tiny v1 model in float32, a prompt of an image and text, and
    five tokens to teacher-force."""
    cfg = _config("tiny_v1")
    mix = json.loads((HERE / "data" / "workloads" / "tiny_v1.b1.json").read_text())["mix"]
    bank = image_bank(mix, 5)
    req = next(r for r in make_requests(mix, 5) if r.kind == "caption")
    tokens = [11, 2222, 333, 4444, 55]
    return cfg, bank, req, tokens


def test_prefix_matches(served):
    from magma_tpu_torch.ops.preprocess import preprocess_uint8_batch

    cfg, bank, _, _ = served
    w = make_weights(cfg["model"], 3, "cpu")
    ref = magma_ref.image_prefix(w, bank[0], cfg["model"], "cpu")
    model = _magma(cfg, make_weights(cfg["model"], 3, "cpu"))
    got = model.embed([preprocess_uint8_batch(bank[0][None], 64, device="cpu")])[0]
    assert torch.allclose(got.float(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [None, 8])
def test_lm_logits_match(served, bits):
    from magma_tpu_torch.models import gptj

    cfg, bank, req, tokens = served
    w = make_weights(cfg["model"], 4, "cpu")
    emb = magma_ref.embed_prompt(w, [bank[v] if k == "image" else v for k, v in req.parts],
                                 cfg["model"], "cpu")
    ref = magma_ref.lm_logits(w, cfg["model"], [emb], [tokens], bits=bits, head_bits=bits)[0]
    model = _magma(cfg, make_weights(cfg["model"], 4, "cpu"))
    if bits:
        model.quantize_for_serving(bits)
    lm = model.params["lm"]
    x = torch.cat([emb, gptj.embed_tokens(model.lm_config, lm, torch.tensor(tokens[:-1]))
                   .float()])[None]
    logits, _ = gptj.forward(model.lm_config, lm, x)
    got = logits[0, emb.shape[0] - 1:, :cfg["model"]["lm"]["vocab_size"]]
    # float32 throughout but the fused int8 adapter, which rounds its input
    # and its hidden layer to bf16 (2^-9): 2e-2 of logits of scale ~1
    tol = 1e-4 if bits is None else 2e-2
    assert (got - ref).abs().max().item() < tol
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_quantize_matches_the_port():
    from magma_tpu_torch.ops.quant import dequantize_int4, quantize_int4, quantize_int8

    w = torch.randn(1024, 384, generator=torch.Generator().manual_seed(0))
    q = quantize_int8(w)
    assert torch.equal(magma_ref.quantize(w, 8), q["q"].float() * q["s"])
    q4 = quantize_int4(w)
    assert torch.allclose(magma_ref.quantize(w, 4), dequantize_int4(q4["q4"], q4["s4"]),
                          rtol=0, atol=1e-6)


def test_training_step_matches():
    """One Trainer step of the tiny v2 recipe in float32 against the
    reference's: the loss, every trainable leaf's first gradient (from
    Adam's first moment) and the BatchNorm statistics."""
    from magma_tpu_torch.training.train_loop import Trainer

    cfg = _config("tiny_v2")
    cell = json.loads((HERE / "data" / "workloads" / "tiny_v2.train.json").read_text())
    seed = 77
    model = _magma(cfg, make_weights(cfg["model"], seed, "cpu"))
    model.config.seed = seed
    trainer = Trainer(model, model.config)
    images, caps = batch(cell, seed, 0, 128, 50256)
    from magma_tpu_torch.ops.preprocess import preprocess_uint8_batch

    x = preprocess_uint8_batch(images, 64, device="cpu").reshape(2, 2, 3, 64, 64)
    loss = trainer.train_step(x, torch.as_tensor(caps).reshape(2, 2, 128))
    got = {p: m / 0.1 for p, m in zip(trainer.optimizer.paths, trainer.optimizer.mu)}

    recipe = dict(cfg["recipe"], ga=2, micro_batch=2, image_side=64)
    with torch.enable_grad():
        ref = train_ref.run_steps(make_weights(cfg["model"], seed, "cpu"), cfg["model"], recipe,
                                  [(images, caps)], seed, "cpu", 1)
    assert loss == pytest.approx(ref["losses"][0], rel=1e-5)
    assert set(got) == set(ref["grads"])
    for k, g in ref["grads"].items():
        assert torch.allclose(got[k], g, rtol=1e-3, atol=1e-5 * max(1.0, float(g.abs().max()))), k
    stats = dict(train_ref.paths(trainer.state["image_prefix"]["enc"]))
    for k, s in ref["stats"].items():
        assert torch.allclose(stats[k], s, rtol=1e-4, atol=1e-5), k
