"""The port's ``MagmaClassifier`` and classification steps against the JAX
package's, on the CPU, at a tiny width with the same weights.

The tower is the tiny ViT (no batch statistics, so ga micro-batches of a
batch give the whole batch's gradient, which JAX takes in one pass), the
LM 2 layers with one 128-wide head (the port runs its flash attention's
plain forward and backward, JAX its XLA attention), fp32 throughout,
dropout 0 (JAX's bits cannot be reproduced), the head drawn from a seed
(its init is zero, which would hide the features' gradients).

Tolerances: loss and logits 1e-5 relative, every gradient within 1e-3 of
its leaf's largest magnitude (fp32 summed in another order, as
test_torch_train_model.py); the Trainer's AdamW steps as there: each
element within 2 lr a step, 98% of each leaf within 5% of lr, losses 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models.classifier import MagmaClassifier as JClassifier
from magma_tpu.models.classifier import collate_fn_classification as jcollate
from magma_tpu.parallel.mesh import make_mesh
from magma_tpu.parallel.partition import combine, partition
from magma_tpu.training.train_loop import Trainer as JTrainer
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models.classifier import MagmaClassifier as TClassifier
from magma_tpu_torch.models.classifier import collate_fn_classification as tcollate
from magma_tpu_torch.training.train_loop import Trainer as TTrainer
from magma_tpu_torch.utils import tree_items

VIT = dict(input_resolution=32, patch_size=16, width=32, layers=1, heads=2, embed_dim=16)
LM = dict(n_layers=2, n_heads=1, d_model=128, d_ff=256, rotary_dim=16, max_seq_len=64)
LR = 2e-3
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-3


def _kwargs(interface="last_token", freeze_model=False, **kw):
    base = dict(
        batch_size=4, train_steps=4, gradient_accumulation_steps=1, lr=LR, warmup_num_steps=0,
        image_enc_lr=1e-3, encoder_name="clip", freeze_img_encoder=False,
        adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.0, image_size=32,
        compute_dtype="float32", param_dtype="float32", frozen_dtype="float32",
        mesh_dp=1, mesh_tp=1,
        class_dict={"num_classes": 3, "interface_type": interface,
                    "freeze_model": freeze_model})
    base.update(kw)
    return base


def _pair(seed=0, **kw):
    jcfg = JConfig(**_kwargs(**kw), lm_overrides=dict(LM, attention_impl="xla"),
                   encoder_overrides=dict(VIT, compute_dtype=jnp.float32))
    tcfg = TConfig(**_kwargs(**kw), lm_overrides=dict(LM, attention_impl="flash"),
                   encoder_overrides=dict(VIT, compute_dtype=torch.float32))
    jm = JClassifier(jcfg, rng=seed)
    r = np.random.default_rng(seed)

    def perturb(path, a):
        keys = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        a = np.asarray(a)
        if keys.startswith("class_head"):
            return jnp.asarray(r.standard_normal(a.shape).astype(np.float32) * 0.1)
        if "adapter" in keys or keys.startswith("image_prefix"):
            return jnp.asarray((a + r.standard_normal(a.shape) * 0.05).astype(a.dtype))
        return jnp.asarray(a)

    jm.params = jax.tree_util.tree_map_with_path(perturb, jm.params)
    tm = TClassifier(tcfg, device="cpu", init_weights=False)
    tm.params, tm.state = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params),
                                          jax.tree_util.tree_map(np.asarray, jm.state),
                                          tm.lm_config, tm.prefix_config)
    return jcfg, tcfg, jm, tm


def _batch(seed, b=4, n_images=2, s=64):
    """NLVR2-style: ``n_images`` image batches, captions of a few tokens then
    EOS (row 0 without EOS: last_token reads the final position), labels."""
    r = np.random.RandomState(seed)
    images = [((r.rand(b, 3, 32, 32) - 0.5) * 4).astype(np.float32) for _ in range(n_images)]
    caps = np.full((b, s), 50256, np.int32)
    caps[0] = r.randint(0, 50000, s)
    for i in range(1, b):
        caps[i, :4 + 3 * i] = r.randint(0, 50000, 4 + 3 * i)
    labels = r.randint(0, 3, b).astype(np.int32)
    return images, caps, labels


def _oihw(a):
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


@pytest.mark.parametrize("interface,n_images", [("last_token", 2), ("mean_pool", 2),
                                                ("last_token", 1)],
                         ids=["last_token_nlvr2", "mean_pool_nlvr2", "last_token_one_image"])
def test_loss_logits_and_gradients_match_jax_grad(interface, n_images):
    _, _, jm, tm = _pair(interface=interface)
    images, caps, labels = _batch(1, n_images=n_images)
    mask = jm.trainable_mask()
    trainable, frozen = partition(jm.params, mask)

    def f(t):
        loss, (_, logits) = jm.classification_loss_fn(
            combine(t, frozen), jm.state, [jnp.asarray(i) for i in images], jnp.asarray(caps),
            jnp.asarray(labels), train=True)
        return loss, logits

    (loss, logits), grads = jax.value_and_grad(f, has_aux=True)(trainable)
    want = {p: _oihw(np.asarray(g)) for p, g in tree_items(grads) if g is not None}
    named = [(p, t) for (p, t), (_, m) in zip(tree_items(tm.params),
                                              tree_items(tm.trainable_mask())) if m]
    assert {p for p, _ in named} == set(want)
    for _, t in named:
        t.requires_grad_(True)
    got_loss, (_, got_logits) = tm.classification_loss_fn(
        tm.params, tm.state, [torch.from_numpy(i) for i in images], torch.from_numpy(caps),
        torch.from_numpy(labels), train=True)
    got = torch.autograd.grad(got_loss, [t for _, t in named])
    for _, t in named:
        t.requires_grad_(False)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(logits),
                               rtol=LOSS_RTOL, atol=LOSS_RTOL * np.abs(logits).max())
    for (path, _), g in zip(named, got):
        w = want[path]
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max() + 1e-12, path
    ref_loss, ref_logits = jm.forward([jnp.asarray(i) for i in images], caps, labels)
    f_loss, f_logits = tm.forward(images, caps, labels)
    np.testing.assert_allclose(f_logits.numpy(), np.asarray(ref_logits), rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * np.abs(ref_logits).max())
    np.testing.assert_allclose(f_loss.item(), float(ref_loss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("freeze_model", [False, True])
def test_trainable_mask_equals_jax(freeze_model):
    _, _, jm, tm = _pair(freeze_model=freeze_model)
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): m
            for path, m in jax.tree_util.tree_leaves_with_path(jm.trainable_mask())}
    got = dict(tree_items(tm.trainable_mask()))
    assert got == want
    assert got["class_head/kernel"] and (not freeze_model) == got["image_prefix/proj/kernel"]


def test_class_head_and_config_checks():
    cfg = TConfig(**_kwargs(), lm_overrides=dict(LM, attention_impl="xla"),
                  encoder_overrides=VIT)
    model = TClassifier(cfg, device="cpu")
    head = model.params["class_head"]
    assert head["kernel"].shape == (128, 3) and not head["kernel"].any()
    bad = TConfig(**_kwargs(), lm_overrides=dict(LM, attention_impl="xla"),
                  encoder_overrides=VIT)
    bad.class_dict = None
    with pytest.raises(ValueError):
        TClassifier(bad, device="cpu", init_weights=False)
    bad.class_dict = {"num_classes": 2, "interface_type": "cls_token"}
    with pytest.raises(ValueError):
        TClassifier(bad, device="cpu", init_weights=False)
    if not torch.cuda.is_available():  # the card is the default, and raises without CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            TClassifier(cfg)


def test_collate_fn_classification_equals_jax():
    r = np.random.RandomState(0)
    batch = [(r.rand(1, 3, 4, 4).astype(np.float32), r.rand(1, 3, 4, 4).astype(np.float32),
              r.randint(0, 9, (1, 12)).astype(np.int32), int(r.randint(0, 2)))
             for _ in range(3)]
    want, got = jcollate(batch, seq_len=10), tcollate(batch, seq_len=10)
    assert len(got[0]) == 2 and got[0][0].shape == (3, 3, 4, 4) and got[1].shape == (3, 10)
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("ga", [1, 2])
def test_trainer_classification_steps_match_jax_trainer(ga):
    """Two train_step_classification steps and one eval step against JAX's
    Trainer on a one-device mesh: the same losses and accuracies, the same
    trainable params, the frozen LM unchanged.  With ga 2 the port takes
    the batch as two micro-batches, JAX in one pass."""
    jcfg, tcfg, jm, tm = _pair(gradient_accumulation_steps=ga)
    jt = JTrainer(jm, jcfg, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    tt = TTrainer(tm, tcfg)
    frozen = {p: t.clone() for p, t in tree_items(tt.params) if not t.requires_grad}
    jl, tl = [], []
    for step in range(2):
        images, caps, labels = _batch(10 + step)
        jl.append(jt.train_step_classification(images, caps, labels))
        tl.append(tt.train_step_classification(images, caps, labels))
    images, caps, labels = _batch(20)
    jl.append(jt.eval_step_classification(images, caps, labels))
    tl.append(tt.eval_step_classification(images, caps, labels))
    np.testing.assert_allclose(np.asarray(tl), np.asarray(jl), rtol=1e-4)
    assert tt.global_step == jt.global_step == 2
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jt.params)))
    for path, t in tree_items(tt.params):
        if path in frozen:
            assert torch.equal(t, frozen[path]), path
            continue
        err = np.abs(t.detach().numpy() - _oihw(want[path]))
        assert (err <= 2 * LR * 2).all(), (path, err.max())
        assert (err <= 0.05 * LR).mean() >= 0.98, path
