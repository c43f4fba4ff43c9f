"""Adapter training end to end: the port's ``Magma.loss_fn`` and ``Trainer``
against the JAX package's, on the CPU, at a tiny width with the same
weights (``convert.from_jax_params``) and numpy-seeded batches.

The config is the v1 recipe shrunk: a 2-layer GPT-J with one 128-wide head
(the port runs its flash attention: the plain forward and backward of the
autograd Function; JAX its XLA attention), a normal mlp adapter, the CLIP
ResNet tower trainable at its own learning rate, ImagePrefix LN, dropout
0 (JAX's dropout bits cannot be reproduced in torch), fp32 throughout
except where the layout says otherwise.  Two layouts: "bf16" (the frozen
LM in its stored dtype, here fp32) and "qlora" (``train_lm_int8``: the
int8 LM of ``quantize_lm_params(fuse_out_proj=False)`` with bf16 adapters).
The other recipes the JAX package trains: "v2_bf16" and "v2_qlora", v2's
normal mlp and attention adapters both at k=8 (the attention adapter fed
by its branch's output); "vit", the ViT-B/32 and its pooled ImagePrefix
(2 tokens); "nfresnet", the NF-ResNet50; the towers at tiny widths and
trainable.  Every adapter and prefix leaf (the towers' included) is moved
off its init: at init an adapter adds ~1e-3 of its branch, which no
tolerance would see.

Tolerances, relative to each leaf's largest magnitude:
* "bf16": fp32 on both sides, another summation order: loss 1e-5,
  gradients 1e-3.
* "qlora": the adapters' gradients are bf16 (2^-8 relative) and the
  port's input gradients of the int8 products follow the kernel (g s
  rounded to bf16) where JAX's CPU VJP stays fp32: loss 1e-5, gradients
  3e-2.
* Trainer: a few AdamW steps.  Adam's first steps move each element by
  about lr whatever the gradient's size, so an element whose gradient is
  near 0 can move the other way in one package: every element is held
  within 2 lr per step, and at least 98% of each leaf's elements within
  5% of lr (bf16 adapters: plus 2^-7 of the value); losses to 1e-4
  relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models.magma import Magma as JMagma
from magma_tpu.parallel.mesh import make_mesh
from magma_tpu.parallel.partition import combine, partition
from magma_tpu.training.train_loop import Trainer as JTrainer
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models.magma import Magma as TMagma
from magma_tpu_torch.training.train_loop import Trainer as TTrainer
from magma_tpu_torch.utils import tree_items

ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)
# layout -> (encoder_name, its tiny overrides) where it is not the CLIP ResNet
TOWERS = {"vit": ("clip", dict(input_resolution=64, patch_size=16, width=32, layers=2, heads=4,
                               embed_dim=24)),
          "nfresnet": ("nfresnet50", dict(width=8, blocks=(1, 2, 1, 1), input_resolution=64))}
V1_ADAPTERS = {"mlp": {"adapter_type": "normal", "downsample_factor": 4}}
V2_ADAPTERS = {"mlp": {"adapter_type": "normal", "downsample_factor": 8},
               "attention": {"adapter_type": "normal", "downsample_factor": 8}}
LAYOUTS = ("bf16", "qlora", "v2_bf16", "v2_qlora", "vit", "nfresnet")
LM = dict(n_layers=2, n_heads=1, d_model=128, d_ff=512, rotary_dim=16, max_seq_len=64)
LOSS_RTOL = 1e-5
GRAD_TOL = {"bf16": 1e-3, "qlora": 3e-2}
LR = 2e-3


def _qlora(layout):
    return layout.endswith("qlora")


def _kwargs(layout, **kw):
    base = dict(
        batch_size=4, train_steps=4, gradient_accumulation_steps=1, lr=LR, warmup_num_steps=0,
        image_enc_lr=1e-3, encoder_name=TOWERS.get(layout, ("clip_resnet_large",))[0],
        adapter_config=V2_ADAPTERS if layout.startswith("v2") else V1_ADAPTERS,
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.0,
        freeze_img_encoder=_qlora(layout), train_lm_int8=_qlora(layout),
        image_size=64, compute_dtype="float32", param_dtype="float32", frozen_dtype="float32",
        mesh_dp=1, mesh_tp=1)
    base.update(kw)
    return base


def _configs(layout, remat=False, **kw):
    enc = TOWERS.get(layout, (None, ENC))[1]
    jcfg = JConfig(**_kwargs(layout, **kw), lm_overrides=dict(LM, attention_impl="xla",
                                                              remat=remat),
                   encoder_overrides=dict(enc, compute_dtype=jnp.float32))
    tcfg = TConfig(**_kwargs(layout, **kw), lm_overrides=dict(LM, attention_impl="flash",
                                                              remat=remat),
                   encoder_overrides=dict(enc, compute_dtype=torch.float32))
    return jcfg, tcfg


def _jax_model(jcfg, seed=0):
    """JAX Magma with its near-zero adapters and identity BN stats perturbed
    so they matter (bf16 leaves stay bf16)."""
    model = JMagma(jcfg, rng=seed)
    r = np.random.default_rng(seed)

    def perturb(path, a):
        keys = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        a = np.asarray(a)
        if "adapter" in keys or keys.startswith("image_prefix"):
            return jnp.asarray((a.astype(np.float32)
                                + r.standard_normal(a.shape) * 0.05).astype(a.dtype))
        return jnp.asarray(a)

    model.params = jax.tree_util.tree_map_with_path(perturb, model.params)
    model.state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + np.abs(r.standard_normal(a.shape)) * 0.2),
        model.state)
    return model


def _port_model(jmodel, tcfg):
    """The port's Magma on the CPU with the JAX model's weights, each leaf in
    the JAX leaf's dtype (the QLoRA adapters are bf16 there)."""
    model = TMagma(tcfg, device="cpu", init_weights=False)
    params_np = jax.tree_util.tree_map(np.asarray, jmodel.params)
    state_np = jax.tree_util.tree_map(np.asarray, jmodel.state)
    params, state = from_jax_params(params_np, state_np, model.lm_config, model.prefix_config)
    want = dict(tree_items(params_np))
    model.params = params
    for path, t in tree_items(model.params):
        if str(want[path].dtype) == "bfloat16" and t.dtype != torch.bfloat16:
            _set(model.params, path, t.to(torch.bfloat16))
    model.state = state
    return model


def _set(tree, path, value):
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    tree[keys[-1]] = value


def _batch(seed, b=2, s=64):
    """Images centred and scaled as CLIP's preprocessing leaves them: on raw
    [0, 1] pixels the stem's batch statistics sit on a large mean, and
    JAX's jitted fp32 BN backward there loses ~2% to cancellation (the
    port's fp32 gradients agree with its fp64 run to 3e-6)."""
    r = np.random.RandomState(seed)
    images = ((r.rand(b, 3, 64, 64) - 0.5) * 4).astype(np.float32)
    caps = np.full((b, s), 50256, np.int32)
    for i in range(b):
        caps[i, :6 + 3 * i] = r.randint(0, 50000, 6 + 3 * i)
    return images, caps


@pytest.fixture(scope="module")
def pairs():
    """layout -> (layout, JAX model, the port's model on its weights), each
    built once for the module."""
    built = {}

    def get(layout):
        if layout not in built:
            jcfg, tcfg = _configs(layout)
            jm = _jax_model(jcfg)
            built[layout] = layout, jm, _port_model(jm, tcfg)
        return built[layout]

    return get


@pytest.mark.parametrize("layout", LAYOUTS)
def test_trainable_mask_equals_jax(pairs, layout):
    _, jm, tm = pairs(layout)
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): m
            for path, m in jax.tree_util.tree_leaves_with_path(jm.trainable_mask())}
    assert dict(tree_items(tm.trainable_mask())) == want


@pytest.mark.parametrize("layout,remat", [
    pytest.param(layout, remat, id=f"{layout}-{'remat' if remat else 'no_remat'}")
    for layout, remat in (("bf16", False), ("bf16", True), ("qlora", False), ("qlora", True),
                          ("v2_bf16", True), ("v2_qlora", True), ("vit", False),
                          ("nfresnet", False))])
def test_loss_and_gradients_match_jax_grad(pairs, layout, remat):
    """Magma.loss_fn's loss and the gradient of every trainable leaf against
    jax.grad of JAX's loss_fn (train=True: batch-statistics BN), the
    towers', the pooled projection's and the attention adapter's
    included."""
    _, jm, tm = pairs(layout)
    jm.lm_config = dataclasses.replace(jm.lm_config, remat=remat)
    tm.lm_config = dataclasses.replace(tm.lm_config, remat=remat)
    images, caps = _batch(1)
    mask = jm.trainable_mask()
    trainable, frozen = partition(jm.params, mask)

    def f(t):
        return jm.loss_fn(combine(t, frozen), jm.state, jnp.asarray(images), jnp.asarray(caps),
                          train=True)[0]

    loss, grads = jax.jit(jax.value_and_grad(f))(trainable)
    want = {path: _oihw(np.asarray(g)) for path, g in tree_items(grads) if g is not None}
    named = [(p, t) for (p, t), (_, m) in zip(tree_items(tm.params),
                                              tree_items(tm.trainable_mask())) if m]
    for _, t in named:
        t.requires_grad_(True)
    got_loss, (new_state, _) = tm.loss_fn(tm.params, tm.state, torch.from_numpy(images),
                                          torch.from_numpy(caps), train=True)
    got = torch.autograd.grad(got_loss, [t for _, t in named])
    for _, t in named:
        t.requires_grad_(False)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=LOSS_RTOL)
    assert {p for p, _ in named} == set(want)
    for (path, _), g in zip(named, got):
        w = want[path].astype(np.float32)
        assert g.dtype == tm_dtype(tm, path), path
        err = np.abs(g.float().numpy() - w).max()
        tol = GRAD_TOL["qlora" if _qlora(layout) else "bf16"]
        assert err <= tol * np.abs(w).max() + 1e-12, (path, err, np.abs(w).max())
    assert set(dict(tree_items(new_state))) == set(dict(tree_items(tm.state)))


def _oihw(a):
    """JAX's HWIO conv kernels (and their gradients) in the port's OIHW."""
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def tm_dtype(tm, path):
    return dict(tree_items(tm.params))[path].dtype


def _loader(images, caps):
    while True:
        yield images, caps


def _run_pair(layout, ga, steps, **kw):
    """JAX's Trainer and the port's from the same weights over the same
    batches.  Returns (JAX trainer, port trainer, JAX losses, port losses,
    the port's frozen leaves before training)."""
    jcfg, tcfg = _configs(layout, gradient_accumulation_steps=ga, batch_size=2 * ga, **kw)
    jm = _jax_model(jcfg)
    tm = _port_model(jm, tcfg)
    jt = JTrainer(jm, jcfg, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    tt = TTrainer(tm, tcfg)
    frozen = {p: t.clone() for p, t in tree_items(tt.params) if not t.requires_grad}
    jl, tl = [], []
    for step in range(steps):
        images, caps = _batch(10 + step, b=2 * ga)
        jl.append(jt.train_step(images, caps))
        tl.append(tt.train_step(images, caps))
    return jt, tt, jl, tl, frozen


def _check_trained(jt, tt, jl, tl, frozen, bf16_rel=0.0):
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = dict(tree_items(jax.tree_util.tree_map(np.asarray, jt.params)))
    for path, t in tree_items(tt.params):
        w = _oihw(want[path])
        if path in frozen:
            assert torch.equal(t, frozen[path]), path  # the frozen LM never moves
            continue
        err = np.abs(t.detach().float().numpy() - w.astype(np.float32))
        close = err <= 0.05 * LR + bf16_rel * np.abs(w.astype(np.float32))
        assert (err <= 2 * LR * len(tl)).all(), (path, err.max())
        assert close.mean() >= 0.98, (path, close.mean())


def test_trainer_steps_match_jax_trainer():
    """Three steps of the bf16 recipe with the encoder trainable (ga 1),
    then a step of v2's adapters and one of the ViT at ga 2 with weight
    decay 0.5, so that a leaf in the wrong group (the encoder's learning
    rate, the no-decay pos_embed and class_token) would move ~0.5 |p| lr
    away from optax's (a step each: JAX's Trainer compiles its step again
    for the second, which would double this test's time): the same
    losses, the same trainable params, the frozen LM unchanged."""
    for layout, ga, steps, wd in (("bf16", 1, 3, 0.0), ("v2_bf16", 2, 1, 0.5),
                                  ("vit", 2, 1, 0.5)):
        jt, tt, jl, tl, frozen = _run_pair(layout, ga=ga, steps=steps, weight_decay=wd)
        assert tt.global_step == jt.global_step == steps, layout
        _check_trained(jt, tt, jl, tl, frozen)


def test_trainer_grad_accum_with_bf16_adapters_qlora():
    """ga 2 over the QLoRA layout (bf16 adapter params): fp32 accumulation,
    cast back to bf16 before the optimizer, as the JAX Trainer does."""
    jt, tt, jl, tl, frozen = _run_pair("qlora", ga=2, steps=2)
    assert all(np.isfinite(tl))
    assert tt.params["lm"]["blocks"]["adapter_mlp"]["down"]["kernel"].dtype == torch.bfloat16
    assert tt.params["lm"]["blocks"]["attn"]["o"]["q"].dtype == torch.int8
    _check_trained(jt, tt, jl, tl, frozen, bf16_rel=2.0 ** -7)


def test_run_blind_eval_and_inference_steps():
    jt, tt, jl, tl, _ = _run_pair("bf16", ga=1, steps=1, run_blind=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    images, caps = _batch(20)
    want = jt.eval_step(_loader(images, caps), eval_steps=2)
    got = tt.eval_step(_loader(images, caps), eval_steps=2)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _, text = tt.inference_step(_loader(images, caps), max_images=1, max_steps=3,
                                temperature=0.0)
    assert text.startswith("Caption 0:")
    assert tt.model.params is tt.params  # sync_model handed the tensors back


def test_save_load_resume(tmp_path):
    """save, load into a fresh Trainer, then one more step each: the same
    params, state, optimizer moments and loss as the trainer that never
    stopped; and a directory with nothing in it resumes from step 0."""
    _, tt, _, _, _ = _run_pair("bf16", ga=1, steps=2)
    tt.save(str(tmp_path))
    assert (tmp_path / "latest").read_text() == "step_2"
    assert (tmp_path / "config.yml").exists() and (tmp_path / "step_2").is_dir()
    jcfg, tcfg = _configs("bf16")
    fresh = TTrainer(_port_model(_jax_model(jcfg, seed=5), tcfg), tcfg)
    assert fresh.load(str(tmp_path / "nothing")) == 0
    assert fresh.load(str(tmp_path)) == 2 and fresh.global_step == 2
    for tree in ("params", "state"):
        want = dict(tree_items(getattr(tt, tree)))
        for path, a in tree_items(getattr(fresh, tree)):
            assert torch.equal(a, want[path]), path
    images, caps = _batch(30)
    np.testing.assert_allclose(fresh.train_step(images, caps), tt.train_step(images, caps),
                               rtol=1e-6)
    want = dict(tree_items(tt.params))
    for path, a in tree_items(fresh.params):
        torch.testing.assert_close(a, want[path], atol=1e-7, rtol=0, msg=path)
