"""Multi-process training of the port against the JAX package's, on the CPU.

* The ``Trainer`` at dp 2 x tp 2 and at dp 2 x sp 2 (ring attention), in 4
  gloo processes each fed the same global batch, against JAX's Trainer on
  the same mesh of 4 virtual devices (``tests/test_trainer.py``,
  ``tests/test_ring_attention.py``): two steps of the v1 recipe shrunk
  (``test_torch_train_model``'s: fp32, the CLIP ResNet trainable with its
  BatchNorm in training mode, so its batch statistics are the global
  batch's; dropout 0, JAX's bits cannot be reproduced).  Losses within
  1e-4 relative; the updated trainable tree as in
  ``test_torch_train_model``: every element within 2 lr per step of JAX's
  and 98% of each leaf's within 5% of lr (Adam's first steps move an
  element by about lr whatever its gradient's size); the ranks' replicas
  equal bit for bit.
  The first step's global gradient, the one AdamW takes, equals the
  port's one-process gradient within 1e-4 relative (fp32, sums in another
  order; a check Adam's sign-like first steps cannot give).  Each then
  saves a checkpoint (rank 0 writes the whole tree, the tp
  shards gathered: its frozen LM equals the weights it started from) and
  loads it back (each rank's shards unchanged).
* The classification steps at dp 4 equal one process's (gradient within
  1e-4, loss and accuracy).
* ``python -m magma_tpu_torch.train --multihost`` as 2 gloo processes:
  every step logged once and one checkpoint written (rank 0's), and the
  loader's rank strides disjoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.parallel.mesh import make_mesh
from magma_tpu.training.train_loop import Trainer as JTrainer
from magma_tpu_torch.utils import tree_items
from test_torch_eval_cli import _cli_yml, _write_dir
from test_torch_train_model import _batch, _jax_model, _oihw
from torch_parallel_worker import spawn

LR = 2e-3
ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)
LM = dict(n_layers=2, n_heads=2, d_model=128, d_ff=512, rotary_dim=16, max_seq_len=64)
MESHES = {"dp_tp": dict(mesh_dp=2, mesh_tp=2, attention_impl="xla"),
          "dp_sp": dict(mesh_dp=2, mesh_tp=1, mesh_sp=2, attention_impl="ring")}


def _kwargs(mesh_kw):
    kw = dict(batch_size=4, train_steps=4, gradient_accumulation_steps=1, lr=LR,
              warmup_num_steps=0, image_enc_lr=1e-3, encoder_name="clip_resnet_large",
              adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
              use_image_embed_layernorm=True, image_embed_dropout_prob=0.0, image_size=64,
              freeze_img_encoder=False,
              compute_dtype="float32", param_dtype="float32", frozen_dtype="float32",
              **{k: v for k, v in mesh_kw.items() if k != "attention_impl"})
    lm = dict(LM, attention_impl=mesh_kw["attention_impl"], remat=False)
    return kw, lm


@pytest.fixture(scope="module")
def runs():
    """{mesh: (JAX losses, JAX trained tree, per-rank port results)}."""
    batches = [_batch(10 + i, b=4) for i in range(2)]
    inputs, jax_side = {}, {}
    for name, mesh_kw in MESHES.items():
        kw, lm = _kwargs(mesh_kw)
        jcfg = JConfig(**kw, lm_overrides=lm,
                       encoder_overrides=dict(ENC, compute_dtype=jnp.float32))
        jm = _jax_model(jcfg)
        params_np = jax.tree_util.tree_map(np.asarray, jm.params)
        state_np = jax.tree_util.tree_map(np.asarray, jm.state)
        inputs[name] = (dict(kw, lm_overrides=lm, encoder_overrides=ENC), params_np, state_np,
                        batches)
        mesh = make_mesh(mesh_kw["mesh_dp"], mesh_kw["mesh_tp"], mesh_kw.get("mesh_sp", 1),
                         devices=jax.devices()[:4])
        jt = JTrainer(jm, jcfg, mesh=mesh)
        losses = [jt.train_step(images, caps) for images, caps in batches]
        jax_side[name] = (losses, dict(tree_items(jax.tree_util.tree_map(np.asarray,
                                                                         jt.params))))
    outs = spawn(["trainer", "classifier"], {"trainer": inputs, "classifier": _classifier_inputs()},
                 4, timeout=400)
    runs = {name: (*jax_side[name], [o["trainer"][name] for o in outs], inputs[name])
            for name in MESHES}
    runs["classifier"] = [o["classifier"] for o in outs]
    return runs


def _classifier_inputs():
    """A tiny ViT ``MagmaClassifier`` (no batch statistics) and one batch of
    4 with labels."""
    cfg_kw = dict(batch_size=4, train_steps=2, gradient_accumulation_steps=1, lr=LR,
                  warmup_num_steps=0, encoder_name="clip", freeze_img_encoder=False,
                  adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
                  image_embed_dropout_prob=0.0, image_size=32, compute_dtype="float32",
                  param_dtype="float32", frozen_dtype="float32",
                  class_dict={"num_classes": 3, "interface_type": "last_token"},
                  lm_overrides=dict(LM, attention_impl="xla", remat=False),
                  encoder_overrides=dict(input_resolution=32, patch_size=16, width=32, layers=1,
                                         heads=2, embed_dim=16, compute_dtype="float32"))
    r = np.random.RandomState(4)
    images = ((r.rand(4, 3, 32, 32) - 0.5) * 4).astype(np.float32)
    caps = np.full((4, 64), 50256, np.int64)
    caps[:, :5] = r.randint(0, 50000, (4, 5))
    return cfg_kw, (images, caps, np.array([0, 2, 1, 2]))


def _one_process_grads(name, cfg_kw, params_np, state_np, batches):
    """The port's first-step gradients in this process, no mesh to run over
    (the ring's sp axis of one rank)."""
    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.convert import from_jax_params
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.parallel.mesh import mesh_from_layout
    from magma_tpu_torch.training.train_loop import Trainer
    from torch_parallel_worker import first_step_grads

    cfg_kw = dict(cfg_kw, encoder_overrides=dict(cfg_kw["encoder_overrides"],
                                                 compute_dtype=torch.float32))
    config = MultimodalConfig(**cfg_kw)
    model = Magma(config, device="cpu", init_weights=False)
    model.params, model.state = from_jax_params(params_np, state_np, model.lm_config,
                                                model.prefix_config)
    layout = np.zeros((1, 1, 1) if MESHES[name].get("mesh_sp") else (1, 1), int)
    names = ("dp", "tp", "sp")[:layout.ndim]
    trainer = Trainer(model, config, mesh=mesh_from_layout(layout, names))
    grads = first_step_grads(trainer)
    trainer.train_step(*batches[0])
    return grads


@pytest.mark.parametrize("name", sorted(MESHES))
def test_trainer_on_a_mesh_matches_jax_trainer(runs, name):
    jl, want, ranks, inputs = runs[name]
    losses, trained, coords, frozen, reloaded, grads = ranks[0]
    # the global gradient the ranks hand AdamW is one process's, to fp32
    # rounding (the rank sums add in another order)
    ref = _one_process_grads(name, *inputs)
    for path, g in ref.items():
        rel = np.linalg.norm(grads[path] - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= 1e-4, (path, rel)
    # the checkpoint gathers the tp shards into the whole frozen LM, and
    # every rank loads its own shards back
    assert frozen and all(frozen.values()), [p for p, ok in frozen.items() if not ok]
    assert all(r[4] for r in ranks)
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    assert losses[1] != losses[0]  # the step moved the params
    assert len({tuple(sorted(r[2].items())) for r in ranks}) == 4  # four places on the mesh
    assert trained and all("adapter" in p or p.startswith("image_prefix") for p in trained)
    for path, t in trained.items():
        w = _oihw(want[path]).astype(np.float32)
        err = np.abs(t - w)
        assert (err <= 2 * LR * len(jl)).all(), (path, err.max())
        assert (err <= 0.05 * LR).mean() >= 0.98, (path, (err <= 0.05 * LR).mean())
        for other in ranks[1:]:  # the replicas stay equal
            np.testing.assert_array_equal(other[1][path], t, err_msg=path)


def test_classifier_steps_at_dp_4_equal_one_process(runs):
    """The Trainer's classification steps at dp 4 (each rank one row): the
    first step's global gradient within 1e-4 of one process's, the same
    loss and accuracy, in training and eval."""
    from torch_parallel_worker import classifier_run

    grads, step, ev = classifier_run(*_classifier_inputs())
    for got_grads, got_step, got_ev in runs["classifier"]:
        np.testing.assert_allclose(got_step, step, rtol=1e-5)
        np.testing.assert_allclose(got_ev, ev, rtol=1e-5)
        for path, g in grads.items():
            rel = np.linalg.norm(got_grads[path] - g) / max(np.linalg.norm(g), 1e-30)
            assert rel <= 1e-4, (path, rel)


LOADER_CASE = r"""
import json, sys
import numpy as np
assert "jax" not in sys.modules
from magma_tpu_torch.utils import init_distributed
from magma_tpu_torch.data.loader import BatchLoader

_, rank, world = init_distributed("cpu")


class Fake:
    def __len__(self):
        return 16

    def __getitem__(self, i):
        return np.full((1, 3, 2, 2), float(i), np.float32), np.full((1, 8), i, np.int32)


loader = BatchLoader(Fake(), batch_size=4, seq_len=8, shuffle=False, flat=True, device="cpu")
_, caps = next(loader)
loader.close()
print("RESULT " + json.dumps(sorted(int(c) for c in caps[:, 0])), flush=True)
"""


def test_train_cli_multihost_and_loader_strides(tmp_path):
    _write_dir(tmp_path / "train", 12, False, 3)
    _write_dir(tmp_path / "vqa", 3, True, 4)
    yml = _cli_yml(tmp_path, 2, False)
    outs = spawn(None, None, 2, argv=["-m", "magma_tpu_torch.train", "--config", yml,
                                      "--device", "cpu", "--multihost"])
    log = [json.loads(x) for x in (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in log if "train/loss" in m] == [1, 2]  # rank 0 alone logs
    assert all(np.isfinite(m["train/loss"]) for m in log if "train/loss" in m)
    assert (tmp_path / "ckpt" / "latest").read_text() == "step_2"
    assert sum(o.count("saving model at step 2") for o in outs) == 1
    assert "params:" in outs[0] and "params:" not in outs[1]

    script = tmp_path / "loader_case.py"
    script.write_text(LOADER_CASE)
    outs = spawn(None, None, 2, argv=[str(script)])
    got = [json.loads(o.split("RESULT ")[-1]) for o in outs]
    assert got == [[0, 2, 4, 6], [1, 3, 5, 7]]  # disjoint strides of the global order
