"""The caption path end to end: JAX ``Magma`` -> reference-named ``.pt``
-> the port's ``Magma.from_checkpoint``, same image and text.

The config is the conftest tiny multimodal config at fp32 (compute, param
and frozen dtypes, and the vision tower's convolutions), with one 128-wide
head so the port's flash entry takes the prefill (its CUDA kernel needs a
head_dim multiple of 128; on the CPU it runs the plain version, padding
included).  The JAX reference runs its XLA attention.  Embeddings must
match at 1e-4 (fp32 math summed in another order) and greedy tokens
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models.magma import Magma as JMagma
from magma_tpu.training.torch_convert import to_torch_state_dict
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models.magma import Magma as TMagma

PROMPT = "Describe the painting:"


def _config_kwargs(attention_impl):
    return dict(
        batch_size=2, train_steps=4, encoder_name="clip_resnet_large",
        adapter_config={
            "mlp": {"adapter_type": "normal", "downsample_factor": 4},
            "attention": {"adapter_type": "scaled_parallel", "downsample_factor": 8},
        },
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.1,
        lm_overrides=dict(n_layers=2, n_heads=1, d_model=128, d_ff=512, rotary_dim=16,
                          max_seq_len=128, attention_impl=attention_impl),
        image_size=64, compute_dtype="float32", param_dtype="float32",
        frozen_dtype="float32", attention_impl=attention_impl,
    )


ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)


@pytest.fixture(scope="module")
def jax_model():
    cfg = JConfig(**_config_kwargs("xla"),
                  encoder_overrides=dict(ENC, compute_dtype=jnp.float32))
    model = JMagma(cfg, rng=0)
    # perturb the near-zero adapters and the identity BN stats so they matter
    r = np.random.default_rng(0)
    model.params = jax.tree_util.tree_map(
        lambda a: a + r.standard_normal(a.shape).astype(np.float32) * 0.02, model.params)
    vocab = model.lm_config.vocab_size  # padding rows stay zero, as exported
    model.params["lm"]["wte"] = model.params["lm"]["wte"].at[vocab:].set(0)
    model.state = jax.tree_util.tree_map(
        lambda a: a + np.abs(r.standard_normal(a.shape)).astype(np.float32) * 0.2, model.state)
    return model


@pytest.fixture(scope="module")
def checkpoint(jax_model, tmp_path_factory):
    sd = to_torch_state_dict(jax_model.params, jax_model.state, jax_model.lm_config,
                             jax_model.prefix_config)
    path = tmp_path_factory.mktemp("ckpt") / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    return path


def _port_config(attention_impl):
    return TConfig(**_config_kwargs(attention_impl),
                   encoder_overrides=dict(ENC, compute_dtype=torch.float32))


def _image():
    arr = np.random.default_rng(7).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    return Image.fromarray(arr)


@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_caption_path_matches_jax(jax_model, checkpoint, attention_impl):
    port = TMagma.from_checkpoint(_port_config(attention_impl), checkpoint, device="cpu")
    assert port.lm_config.attention_impl == attention_impl

    ref_emb = np.asarray(jax_model.preprocess_inputs([_image(), PROMPT]))
    emb = port.preprocess_inputs([_image(), PROMPT])
    n_text = len(port.tokenizer.encode(PROMPT)[0])
    assert emb.shape == (1, port.image_prefix_seq_len + n_text, 128)
    np.testing.assert_allclose(emb.numpy(), ref_emb, atol=1e-4)

    ref_tokens = jax_model.generate(jnp.asarray(ref_emb), max_steps=8, temperature=0.0,
                                    decode=False)
    tokens = port.generate(emb, max_steps=8, temperature=0.0, decode=False)
    np.testing.assert_array_equal(tokens, np.asarray(ref_tokens))
    assert port.generate(emb, max_steps=8, temperature=0.0) == jax_model.generate(
        jnp.asarray(ref_emb), max_steps=8, temperature=0.0)


def test_from_jax_params_equals_checkpoint_load(jax_model, checkpoint):
    """Both weight bridges give the same tensors, key for key."""
    port = TMagma.from_checkpoint(_port_config("xla"), checkpoint, device="cpu")
    params_np = jax.tree_util.tree_map(np.asarray, jax_model.params)
    state_np = jax.tree_util.tree_map(np.asarray, jax_model.state)
    params, state = from_jax_params(params_np, state_np, port.lm_config,
                                    port.prefix_config)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    for got, want in ((params, port.params), (state, port.state)):
        got, want = dict(flat(got)), dict(flat(want))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


def test_random_init_runs_the_path():
    """A seeded port model answers a request without any checkpoint."""
    model = TMagma(_port_config("flash"), seed=3, device="cpu")
    emb = model.preprocess_inputs([_image(), PROMPT])
    out = model.generate(emb, max_steps=4, temperature=0.7, top_k=5,
                         generator=torch.Generator().manual_seed(0))
    assert isinstance(out, list) and len(out) == 1 and isinstance(out[0], str)


def test_entry_points_default_to_the_gpu(checkpoint, monkeypatch):
    """Without a device the facade asks for CUDA: where there is none it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TMagma(_port_config("flash"), seed=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TMagma.from_checkpoint(_port_config("flash"), checkpoint)
