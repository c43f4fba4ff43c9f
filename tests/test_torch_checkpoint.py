"""Checkpoint restore from a directory: the port's ``Trainer.save`` ->
``Magma.from_checkpoint(directory)`` (``training.checkpoint.restore_params``),
against the JAX package's LM on the same weights, on the CPU.

The config is the v2 recipe shrunk (a normal mlp adapter at k=4 and a
normal attention adapter at k=8) over a 2-layer GPT-J with one 128-wide
head and a tiny CLIP ResNet, fp32 throughout.  A restore copies the saved
tensors into the template's in place, so params and BN statistics must be
bit-equal to what was saved, from the save root and from its step
directory, and greedy tokens identical before and after the round trip and
to JAX's.

The Trainer's resume (``Trainer.load``) goes through the same checked
restore: a clean resume copies params, state, moments and counts into the
live tensors bit for bit, and a file of another layout (an extra adapter,
a missing leaf, a leaf or a moment of another but broadcastable shape)
raises a ``ValueError`` naming the leaf and restores nothing.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models.magma import Magma as JMagma
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.models.magma import Magma as TMagma
from magma_tpu_torch.training import checkpoint as ckpt
from magma_tpu_torch.training.train_loop import Trainer as TTrainer
from magma_tpu_torch.utils import tree_items, tree_map

PROMPT = "Describe the painting:"
ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)
V2_ADAPTERS = {"mlp": {"adapter_type": "normal", "downsample_factor": 4},
               "attention": {"adapter_type": "normal", "downsample_factor": 8}}
V1_ADAPTERS = {"mlp": {"adapter_type": "normal", "downsample_factor": 4}}


def _kwargs(adapters=V2_ADAPTERS, **kw):
    base = dict(
        batch_size=2, train_steps=4, lr=1e-3, warmup_num_steps=0,
        encoder_name="clip_resnet_large", adapter_config=adapters,
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.0, image_size=64,
        lm_overrides=dict(n_layers=2, n_heads=1, d_model=128, d_ff=512, rotary_dim=16,
                          max_seq_len=128, attention_impl="xla"),
        compute_dtype="float32", param_dtype="float32", frozen_dtype="float32",
        attention_impl="xla", mesh_dp=1, mesh_tp=1)
    base.update(kw)
    return base


def _tconfig(**kw):
    return TConfig(**_kwargs(**kw), encoder_overrides=dict(ENC, compute_dtype=torch.float32))


def _image():
    return Image.fromarray(np.random.default_rng(7).integers(0, 256, (48, 80, 3),
                                                             dtype=np.uint8))


def _greedy(model, emb):
    return model.generate(emb, max_steps=8, temperature=0.0, decode=False)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(JAX's greedy tokens, the port's model, the save root the port's
    Trainer wrote).  The port's weights are its random init, every leaf
    moved off it (the near-zero adapters and identity BN statistics would
    hide faults); the JAX model runs the same LM weights (no JAX init: it
    compiles for seconds) on the port's embeddings."""
    tm = TMagma(_tconfig(), seed=5, device="cpu")
    g = torch.Generator().manual_seed(0)
    tm.params = tree_map(lambda t: t + torch.randn(t.shape, generator=g) * 0.02, tm.params)
    tm.state = tree_map(lambda t: t + torch.randn(t.shape, generator=g).abs() * 0.2, tm.state)
    root = tmp_path_factory.mktemp("ckpt") / "run"
    trainer = TTrainer(tm, tm.config)
    trainer.save(str(root))
    trainer.sync_model()  # the Trainer holds the params until handed back
    jm = JMagma(JConfig(**_kwargs(), encoder_overrides=dict(ENC, compute_dtype=jnp.float32)),
                init_weights=False)
    jm.params = {"lm": tree_map(lambda t: jnp.asarray(t.detach().numpy()), tm.params["lm"])}
    emb = tm.preprocess_inputs([_image(), PROMPT])
    return np.asarray(_greedy(jm, jnp.asarray(emb.numpy()))), tm, root


@pytest.mark.parametrize("where", ["root", "step_dir"])
def test_trainer_save_restores_bit_equal_with_the_same_tokens(saved, where):
    ref_tokens, tm, root = saved
    path = root if where == "root" else root / "step_0"
    got = TMagma.from_checkpoint(tm.config, path, device="cpu")
    for name, mine, theirs in (("params", got.params, tm.params), ("state", got.state, tm.state)):
        want = dict(tree_items(theirs))
        have = dict(tree_items(mine))
        assert have.keys() == want.keys(), name
        for k, t in have.items():
            assert t.dtype == want[k].dtype and torch.equal(t, want[k]), (name, k)
    emb = tm.preprocess_inputs([_image(), PROMPT])
    before = _greedy(tm, emb)
    np.testing.assert_array_equal(_greedy(got, got.preprocess_inputs([_image(), PROMPT])), before)
    np.testing.assert_array_equal(before, ref_tokens)


def test_restore_without_state_keeps_the_template(saved, tmp_path):
    _, tm, _ = saved
    ckpt.save_checkpoint(str(tmp_path), 3, tm.params)  # no "state"
    template = TMagma(tm.config, seed=1, device="cpu")
    state = template.state
    kept = {k: t.clone() for k, t in tree_items(state)}
    params, got_state = ckpt.restore_params(str(tmp_path / "step_3"), template.params, state)
    assert got_state is state and params is template.params
    assert all(torch.equal(t, kept[k]) for k, t in tree_items(got_state))
    want = dict(tree_items(tm.params))
    assert all(torch.equal(t, want[k]) for k, t in tree_items(params))


def test_restore_refuses_another_recipe_a_corrupt_file_and_an_empty_dir(tmp_path):
    v1 = TMagma(_tconfig(adapters=V1_ADAPTERS), device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "v1"), 0, v1.params, v1.state)
    with pytest.raises(ValueError, match="adapter_attn"):
        TMagma.from_checkpoint(_tconfig(), tmp_path / "v1", device="cpu")
    wide = _tconfig(adapters={"mlp": {"adapter_type": "normal", "downsample_factor": 2}})
    with pytest.raises(ValueError, match="adapter_mlp/down/kernel"):
        TMagma.from_checkpoint(wide, tmp_path / "v1", device="cpu")
    (tmp_path / "v1" / "step_0" / "checkpoint.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        TMagma.from_checkpoint(_tconfig(adapters=V1_ADAPTERS), tmp_path / "v1", device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        TMagma.from_checkpoint(_tconfig(adapters=V1_ADAPTERS), tmp_path / "empty", device="cpu")


def test_train_lm_int8_checkpoint_restores_into_the_int8_template(tmp_path):
    cfg = _tconfig(adapters=V1_ADAPTERS, train_lm_int8=True, freeze_img_encoder=True)
    model = TMagma(cfg, seed=3, device="cpu")
    assert model.params["lm"]["blocks"]["attn"]["in_proj"]["q"].dtype == torch.int8
    trainer = TTrainer(model, cfg)
    trainer.save(str(tmp_path))
    trainer.sync_model()
    got = TMagma.from_checkpoint(cfg, tmp_path, device="cpu")
    want = dict(tree_items(model.params))
    for k, t in tree_items(got.params):
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k
    assert got.params["lm"]["blocks"]["attn"]["o"]["q"].dtype == torch.int8


def _trained(cfg, seed, steps):
    """A Trainer of a seeded model after ``steps`` steps, so that its
    moments and counts are off zero."""
    trainer = TTrainer(TMagma(cfg, seed=seed, device="cpu"), cfg)
    r = np.random.default_rng(seed)
    for _ in range(steps):
        caps = np.full((2, 128), 50256, np.int64)
        caps[:, :10] = r.integers(0, 50000, (2, 10))
        trainer.train_step(r.standard_normal((2, 3, 64, 64)).astype(np.float32), caps)
    return trainer


def test_trainer_resume_restores_params_state_moments_and_step_in_place(tmp_path):
    src = _trained(_tconfig(), 5, steps=2)
    src.save(str(tmp_path))
    dst = TTrainer(TMagma(_tconfig(), seed=6, device="cpu"), _tconfig())
    live = dict(tree_items(dst.params))
    assert dst.load(str(tmp_path / "nothing")) == 0 and dst.global_step == 0
    assert dst.load(str(tmp_path)) == 2 and dst.global_step == 2
    for name in ("params", "state"):
        want = dict(tree_items(getattr(src, name)))
        have = dict(tree_items(getattr(dst, name)))
        assert have.keys() == want.keys(), name
        for k, t in have.items():
            assert t.dtype == want[k].dtype and torch.equal(t, want[k]), (name, k)
    assert all(t is live[k] for k, t in tree_items(dst.params))  # copied in place
    want, have = src.optimizer.state_dict(), dst.optimizer.state_dict()
    for moment in ("mu", "nu"):
        assert have[moment].keys() == want[moment].keys()
        assert all(torch.equal(t, want[moment][k]) for k, t in have[moment].items()), moment
    assert [have[k] for k in ("count", "notfinite_count", "total_notfinite")] == \
        [want[k] for k in ("count", "notfinite_count", "total_notfinite")] == [2, 0, 0]


@pytest.fixture(scope="module")
def v2_payload(tmp_path_factory):
    """The checkpoint of a v2 Trainer after one step, as the file holds it."""
    root = tmp_path_factory.mktemp("v2") / "run"
    _trained(_tconfig(), 5, steps=1).save(str(root))
    return torch.load(root / "step_1" / ckpt.CKPT_FILE, weights_only=True)


# each fault's file -> what the error names
FAULTS = {"extra_adapter": "params/lm/blocks/adapter_attn: not in the model",
          "missing_leaf": "params/lm/blocks/adapter_mlp/up/bias: not in the file",
          "broadcast_shape": "params/lm/blocks/adapter_mlp/down/bias: (1, 32)",
          "broadcast_moment": "opt_state/mu/lm/blocks/adapter_attn/up/bias: (1, 128)"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_resume_refuses_a_checkpoint_of_another_layout(v2_payload, tmp_path, fault):
    """Each file resumed wrongly before the checked restore (the extra key
    dropped, the missing one a bare KeyError, the broadcastable shapes
    broadcast into the live tensors).  ``restore_params`` refuses the same
    params; it reads no optimizer state."""
    leaf = FAULTS[fault]
    payload = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, v2_payload)
    blocks = payload["params"]["lm"]["blocks"]
    if fault == "missing_leaf":
        del blocks["adapter_mlp"]["up"]["bias"]
    elif fault == "broadcast_shape":
        blocks["adapter_mlp"]["down"]["bias"] = blocks["adapter_mlp"]["down"]["bias"][:1]
    elif fault == "broadcast_moment":
        mu = payload["opt_state"]["mu"]
        mu["lm/blocks/adapter_attn/up/bias"] = mu["lm/blocks/adapter_attn/up/bias"][:1]
    ckpt.save_checkpoint(str(tmp_path), 1, payload["params"], payload["state"],
                         payload["opt_state"])
    cfg = _tconfig(adapters=V1_ADAPTERS) if fault == "extra_adapter" else _tconfig()
    trainer = TTrainer(TMagma(cfg, seed=6, device="cpu"), cfg)
    before = {k: t.clone() for k, t in tree_items(trainer.params)}
    moments = [t.clone() for t in trainer.optimizer.mu]
    with pytest.raises(ValueError, match=re.escape(leaf)):
        trainer.load(str(tmp_path))
    assert trainer.global_step == 0
    assert all(torch.equal(t, before[k]) for k, t in tree_items(trainer.params))
    assert all(torch.equal(a, b) for a, b in zip(trainer.optimizer.mu, moments))
    template = TMagma(cfg, seed=6, device="cpu")
    if fault == "broadcast_moment":
        ckpt.restore_params(str(tmp_path), template.params, template.state)
        assert torch.equal(template.params["lm"]["blocks"]["adapter_attn"]["up"]["bias"],
                           v2_payload["params"]["lm"]["blocks"]["adapter_attn"]["up"]["bias"])
    else:
        with pytest.raises(ValueError, match=re.escape(leaf)):
            ckpt.restore_params(str(tmp_path), template.params, template.state)
