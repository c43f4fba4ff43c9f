"""Port's vision path vs the JAX package's: preprocessing, the CLIP ResNet
and the ImagePrefix, on the conftest encoder (width 16, blocks (1,1,1,1),
64 px) with fp32 convolutions in both, so the comparison is of the
algorithm (tolerance 1e-4: fp32 convolutions summed in another order).

The conv test also guards XLA's "SAME" padding: at stride 2 on an even
input it pads (0, 1), where torch's ``padding=1`` would pad (1, 1) and
move the whole stem output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from magma_tpu.models import clip_resnet as jclip
from magma_tpu.models import image_prefix as jip
from magma_tpu.ops.preprocess import clip_preprocess as jax_clip_preprocess
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import clip_resnet as tclip
from magma_tpu_torch.models import image_prefix as tip
from magma_tpu_torch.ops.preprocess import clip_preprocess

ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)


def _image(h=480, w=640, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("hw", [(480, 640), (640, 480)])
def test_clip_preprocess_matches_jax(hw):
    """Antialiased bicubic resize + crop + normalise, 480x640 -> 384.
    atol 1e-5: the two resize kernels agree to ~1e-6 on [0, 1] pixels,
    which the CLIP std (~0.27) scales up about fourfold."""
    img = _image(*hw)
    ref = np.asarray(jax_clip_preprocess(jnp.asarray(img), 384))
    out = clip_preprocess(torch.from_numpy(img), 384)
    assert out.shape == (1, 3, 384, 384) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def _encoder_params(seed=0):
    """JAX CLIP ResNet params with non-trivial BN statistics."""
    jcfg = jclip.ClipResNetConfig.named("clip_resnet_large", compute_dtype=jnp.float32, **ENC)
    p, s = jclip.init_params(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree_util.tree_map(np.asarray, p)
    r = np.random.default_rng(seed)
    s = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + np.abs(r.standard_normal(a.shape)) * 0.3).astype(np.float32), s)
    return jcfg, p, s


def test_same_padding_at_stride_2():
    assert tclip._same_pads(8, 3, 2) == (0, 1)
    assert tclip._same_pads(8, 3, 1) == (1, 1)
    r = np.random.default_rng(0)
    x = r.standard_normal((1, 8, 8, 3)).astype(np.float32)
    w = r.standard_normal((3, 3, 3, 4)).astype(np.float32)  # HWIO
    ref = jclip._conv(jnp.asarray(x), jnp.asarray(w), 2, jnp.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    out = tclip._conv(xt, wt, 2, torch.float32).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    torchvision_habit = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1)
    assert np.abs(torchvision_habit.numpy() - np.asarray(ref)).max() > 0.1


def test_clip_resnet_apply_matches_jax():
    jcfg, p, s = _encoder_params()
    images = np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(np.float32)
    ref, _ = jclip.apply(p, s, jnp.asarray(images), jcfg)
    tcfg = tclip.ClipResNetConfig.named("clip_resnet_large", compute_dtype=torch.float32, **ENC)
    tp, ts = from_jax_params({"lm": {}, "image_prefix": {"enc": p}},
                             {"image_prefix": {"enc": s}}, None, None)
    out, _ = tclip.apply(tp["image_prefix"]["enc"], ts["image_prefix"]["enc"],
                         torch.from_numpy(images), tcfg)
    assert out.shape == (2, tcfg.out_tokens, tcfg.out_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_image_prefix_apply_matches_jax():
    enc_ov = dict(ENC, compute_dtype=jnp.float32)
    jcfg = jip.ImagePrefixConfig(
        encoder_name="clip_resnet_large", out_dim=128, use_layernorm=True,
        dropout_prob=0.1, encoder_overrides=tuple(sorted(enc_ov.items())),
        compute_dtype=jnp.float32)
    p, s = jip.init_params(jax.random.PRNGKey(3), jcfg)
    p = jax.tree_util.tree_map(np.asarray, p)
    r = np.random.default_rng(3)
    p["ln"] = {"scale": (1 + r.standard_normal(128) * 0.1).astype(np.float32),
               "bias": (r.standard_normal(128) * 0.1).astype(np.float32)}
    s = jax.tree_util.tree_map(np.asarray, s)
    images = r.standard_normal((1, 3, 64, 64)).astype(np.float32)
    ref, _ = jip.apply(p, s, jnp.asarray(images), jcfg, train=False)

    tcfg = tip.ImagePrefixConfig(
        encoder_name="clip_resnet_large", out_dim=128, use_layernorm=True,
        encoder_overrides=tuple(sorted(dict(ENC, compute_dtype=torch.float32).items())),
        compute_dtype=torch.float32)
    tp, ts = from_jax_params({"lm": {}, "image_prefix": p}, {"image_prefix": s}, None, None)
    out, _ = tip.apply(tp["image_prefix"], ts["image_prefix"], torch.from_numpy(images), tcfg)
    assert out.shape == (1, 4, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_unported_towers_raise():
    for name in ("clip", "nfresnet50"):
        with pytest.raises(NotImplementedError):
            tip.ImagePrefixConfig(encoder_name=name).encoder
