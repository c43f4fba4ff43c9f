"""The port's pooled towers against the JAX package's: the CLIP ViT-B/32
("clip") and NF-ResNet50 ("nfresnet50"), the pooled ImagePrefix, both weight
bridges (``from_jax_params`` and the reference-named state dict of JAX's
``to_torch_state_dict``), and ``Magma`` with each tower end to end.

The same numpy-seeded weights go through both packages at tiny widths
with fp32 compute, so the comparison is of the algorithm: tower outputs
within 1e-5 of their largest magnitude (fp32 convolutions and products
summed in another order), prefix embeddings within 1e-4 (the CLIP resize
of the two packages agrees to ~1e-5), greedy tokens identical.  The NF
tests run an even input, where XLA's "SAME" pads stride-2 convolutions
asymmetrically: (2, 3) for the 7x7 stem, (0, 1) for a 3x3.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models import clip_vit as jvit
from magma_tpu.models import image_prefix as jip
from magma_tpu.models import nfnet as jnf
from magma_tpu.models.magma import Magma as JMagma
from magma_tpu.training.torch_convert import to_torch_state_dict
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import (convert_state_dict, from_jax_params,
                                     load_pretrained_encoder)
from magma_tpu_torch.models import clip_vit as tvit
from magma_tpu_torch.models import image_prefix as tip
from magma_tpu_torch.models import nfnet as tnf
from magma_tpu_torch.models.magma import Magma as TMagma
from magma_tpu_torch.utils import tree_items

TOWER_RTOL = 1e-5
EMB_ATOL = 1e-4
TINY = {
    "clip": dict(input_resolution=64, patch_size=16, width=32, layers=2, heads=4, embed_dim=24),
    "nfresnet50": dict(width=8, blocks=(1, 2, 1, 1), input_resolution=64),
}
PROMPT = "Describe the painting:"


def _perturbed(tree, seed, scale=0.05):
    """numpy copy of a JAX tree with every leaf moved off its init (the LN
    scales off 1, the NF skipinit gains off 0), so each one matters."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + r.standard_normal(np.shape(a)) * scale).astype(np.float32),
        tree)


def _tower(name):
    if name == "clip":
        return jvit, tvit, jvit.ClipViTConfig, tvit.ClipViTConfig
    return jnf, tnf, jnf.NFResNetConfig, tnf.NFResNetConfig


def _images(b, res, seed):
    return np.random.default_rng(seed).standard_normal((b, 3, res, res)).astype(np.float32)


@pytest.mark.parametrize("name,ov", [
    ("clip", TINY["clip"]),
    ("clip", dict(input_resolution=64, patch_size=32, width=48, layers=3, heads=6, embed_dim=16)),
    ("nfresnet50", TINY["nfresnet50"]),
    ("nfresnet50", dict(width=8, blocks=(1, 1, 2, 1), input_resolution=62)),
], ids=["vit_p16", "vit_p32", "nf_even", "nf_odd"])
def test_tower_apply_matches_jax(name, ov):
    jm, tm, jcls, tcls = _tower(name)
    jcfg = jcls(compute_dtype=jnp.float32, **ov)
    p, s = jm.init_params(jax.random.PRNGKey(0), jcfg)
    p = _perturbed(p, 0)
    images = _images(2, ov["input_resolution"], 1)
    ref, _ = jm.apply(p, s, jnp.asarray(images), jcfg)
    tp, _ = from_jax_params({"lm": {}, "image_prefix": {"enc": p}}, None, None, None)
    out, stats = tm.apply(tp["image_prefix"]["enc"], {}, torch.from_numpy(images),
                          tcls(compute_dtype=torch.float32, **ov), train=True)
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, jcfg.out_dim) and stats == {}
    np.testing.assert_allclose(out.numpy(), ref, atol=TOWER_RTOL * np.abs(ref).max())


def test_ws_conv_and_max_pool_pad_same_as_xla():
    """The stem's 7x7/2 WS conv and the 3x3/2 max pool on an even input:
    XLA's (2, 3) and (0, 1) pads, which torch's symmetric padding misses."""
    r = np.random.default_rng(0)
    x = r.standard_normal((1, 16, 16, 3)).astype(np.float32)
    p = {"kernel": r.standard_normal((7, 7, 3, 4)).astype(np.float32),
         "gain": (1 + r.standard_normal(4) * 0.1).astype(np.float32),
         "bias": (r.standard_normal(4) * 0.1).astype(np.float32)}
    ref = np.asarray(jnf._ws_conv(jnp.asarray(x), p, 2, jnp.float32))
    tp = {"kernel": torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1).copy()),
          "gain": torch.from_numpy(p["gain"]), "bias": torch.from_numpy(p["bias"])}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = tnf._ws_conv(xt, tp, 2, torch.float32)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4)
    k = tp["kernel"]
    k_std = (k - k.mean((1, 2, 3), keepdim=True)) * torch.rsqrt(
        k.var((1, 2, 3), keepdim=True, unbiased=False) * k[0].numel() + 1e-4)
    symmetric = F.conv2d(xt, k_std * tp["gain"][:, None, None, None], tp["bias"], 2, 3)
    assert np.abs(symmetric.permute(0, 2, 3, 1).numpy() - ref).max() > 0.1

    y = r.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ref_pool = jax.lax.reduce_window(jnp.asarray(y), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                     (1, 2, 2, 1), "SAME")
    pool = tnf._max_pool_same(torch.from_numpy(y).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(ref_pool))


def _prefix_configs(name, image_seq_len=3):
    kw = dict(encoder_name=name, out_dim=64, image_seq_len=image_seq_len, use_layernorm=True,
              dropout_prob=0.1)
    jcfg = jip.ImagePrefixConfig(
        encoder_overrides=tuple(sorted(dict(TINY[name], compute_dtype=jnp.float32).items())),
        compute_dtype=jnp.float32, **kw)
    tcfg = tip.ImagePrefixConfig(
        encoder_overrides=tuple(sorted(dict(TINY[name], compute_dtype=torch.float32).items())),
        compute_dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("name", ["clip", "nfresnet50"])
def test_pooled_image_prefix_matches_jax(name):
    """Projection to out_dim * image_seq_len, reshape, dropout, LN: eval
    against JAX's; in training, dropout keeps or zeroes and rescales the
    eval embedding's elements (the bits come from the generator)."""
    jcfg, tcfg = _prefix_configs(name)
    p, s = jip.init_params(jax.random.PRNGKey(2), jcfg)
    p = _perturbed(p, 2)
    images = _images(2, 64, 3)
    ref, _ = jip.apply(p, s, jnp.asarray(images), jcfg, train=False)
    tp, ts = from_jax_params({"lm": {}, "image_prefix": p}, {"image_prefix": {"enc": {}}},
                             None, None)
    assert tcfg.out_seq_len == jcfg.out_seq_len == 3
    out, _ = tip.apply(tp["image_prefix"], ts["image_prefix"], torch.from_numpy(images), tcfg)
    assert out.shape == (2, 3, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=EMB_ATOL)

    no_ln = {k: v for k, v in tp["image_prefix"].items() if k != "ln"}
    x_eval, _ = tip.apply(no_ln, ts["image_prefix"], torch.from_numpy(images), tcfg)
    g = torch.Generator().manual_seed(0)
    x_train, _ = tip.apply(no_ln, ts["image_prefix"], torch.from_numpy(images), tcfg,
                           train=True, generator=g)
    kept = x_train != 0
    torch.testing.assert_close(x_train[kept], x_eval[kept] / 0.9)
    assert 0.8 < kept.float().mean().item() < 0.97


@pytest.mark.parametrize("name", ["clip", "nfresnet50"])
def test_fold_for_serving_keeps_the_pooled_tower(name):
    _, tcfg = _prefix_configs(name)
    params, stats = tip.init_params(torch.Generator().manual_seed(0), tcfg)
    folded = tip.fold_for_serving(params, stats, tcfg)
    assert folded["enc"] is params["enc"]
    assert folded["proj"]["kernel"].dtype == torch.bfloat16


def _magma_kwargs(name):
    return dict(
        batch_size=2, train_steps=4, encoder_name=name, image_seq_len=3,
        adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.1, image_size=64,
        lm_overrides=dict(n_layers=2, n_heads=4, d_model=128, d_ff=512, rotary_dim=16,
                          max_seq_len=128, attention_impl="xla"),
        compute_dtype="float32", param_dtype="float32", frozen_dtype="float32",
        attention_impl="xla")


@pytest.fixture(scope="module", params=["clip", "nfresnet50"])
def magma_pair(request):
    name = request.param
    jm = JMagma(JConfig(**_magma_kwargs(name),
                        encoder_overrides=dict(TINY[name], compute_dtype=jnp.float32)), rng=0)
    r = np.random.default_rng(0)
    jm.params = jax.tree_util.tree_map(
        lambda a: a + r.standard_normal(a.shape).astype(np.float32) * 0.02, jm.params)
    vocab = jm.lm_config.vocab_size  # padding rows stay zero, as exported
    jm.params["lm"]["wte"] = jm.params["lm"]["wte"].at[vocab:].set(0)
    tm = TMagma(TConfig(**_magma_kwargs(name),
                        encoder_overrides=dict(TINY[name], compute_dtype=torch.float32)),
                device="cpu", init_weights=False)
    tm.params, tm.state = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params),
                                          jax.tree_util.tree_map(np.asarray, jm.state),
                                          tm.lm_config, tm.prefix_config)
    return name, jm, tm


def test_state_dict_import_equals_from_jax_params(magma_pair):
    """JAX's ``to_torch_state_dict`` (OpenAI ViT / timm NF names) through
    ``convert_state_dict`` gives the tensors ``from_jax_params`` gives,
    key for key; the tower alone loads through ``load_pretrained_encoder``
    (a whole CLIP model's ``visual.`` nesting detected)."""
    name, jm, tm = magma_pair
    sd = to_torch_state_dict(jm.params, jm.state, jm.lm_config, jm.prefix_config)
    params, state = convert_state_dict(sd, tm.lm_config, tm.prefix_config)
    want = dict(tree_items(tm.params))
    got = dict(tree_items(params))
    assert set(got) == set(want)
    for path, t in got.items():
        assert torch.equal(t, want[path].to(t.dtype)), path
    assert state == {"image_prefix": {"enc": {}}}

    enc_prefix = "visual." if name == "clip" else ""
    enc_sd = {enc_prefix + k[len("image_prefix.enc."):]: torch.from_numpy(np.array(v))
              for k, v in sd.items() if k.startswith("image_prefix.enc.")}
    fresh = TMagma(tm.config, device="cpu", init_weights=True)
    load_pretrained_encoder(fresh, enc_sd)
    for path, t in tree_items(fresh.params["image_prefix"]["enc"]):
        assert torch.equal(t, dict(tree_items(tm.params["image_prefix"]["enc"]))[path]), path


def _pil(seed=7):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (48, 80, 3),
                                                                dtype=np.uint8))


def test_magma_greedy_tokens_match_jax(magma_pair):
    """preprocess_inputs -> embed -> greedy generate through both packages:
    embeddings within 1e-4, tokens identical.  The NF-ResNet's random crop
    draws from Python's ``random``, seeded before each package's call."""
    name, jm, tm = magma_pair
    random.seed(5)
    ref_emb = np.asarray(jm.preprocess_inputs([_pil(), PROMPT]))
    random.seed(5)
    emb = tm.preprocess_inputs([_pil(), PROMPT])
    n_text = len(tm.tokenizer.encode(PROMPT)[0])
    assert emb.shape == (1, 3 + n_text, 128) and tm.image_prefix_seq_len == 3
    np.testing.assert_allclose(emb.numpy(), ref_emb, atol=EMB_ATOL)
    ref = jm.generate(jnp.asarray(ref_emb), max_steps=8, temperature=0.0, decode=False)
    got = tm.generate(emb, max_steps=8, temperature=0.0, decode=False)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_default_config_builds_the_vit_b32():
    """``MultimodalConfig()``'s encoder is the ViT-B/32 at its published
    widths (224 px, 12 x 768, 12 heads, 512-dim output): ``Magma`` builds it
    and generates (the LM cut to a tiny width to fit a CPU test)."""
    cfg = TConfig(batch_size=1, train_steps=1, lm_overrides=dict(
        n_layers=1, n_heads=1, d_model=128, d_ff=256, rotary_dim=16, max_seq_len=64,
        attention_impl="xla"))
    model = TMagma(cfg, device="cpu")
    module, enc, pooled = model.prefix_config.encoder
    assert module is tvit and pooled and cfg.encoder_name == "clip"
    assert (enc.input_resolution, enc.patch_size, enc.width, enc.layers, enc.heads,
            enc.out_dim) == (224, 32, 768, 12, 12, 512)
    assert model.image_prefix_seq_len == cfg.image_seq_len == 2
    assert model.params["image_prefix"]["proj"]["kernel"].shape == (512, 2 * 128)
    emb = model.preprocess_inputs([_pil(), PROMPT])
    assert emb.shape[:2] == (1, 2 + len(model.tokenizer.encode(PROMPT)[0]))
    tokens = model.generate(emb, max_steps=2, temperature=0.0, decode=False)
    assert tokens.shape == (1, 2)
