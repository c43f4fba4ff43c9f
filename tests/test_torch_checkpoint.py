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
"""

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
