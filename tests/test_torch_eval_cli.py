"""The port's evaluation, observability and training CLI against the JAX
package's, on the CPU at a tiny width.

* evaluation: the VQA metric on the same cases; ``eval_vqa``'s answers
  identical to JAX's (the same weights, fp32, greedy, a ragged batch of
  right-padded prompts); ``eval_loss`` within 1e-4 relative (the two CLIP
  resizes differ by ~1e-5 a pixel, fp32 summed in another order);
* observability: ``make_grid`` equal, ``device_memory_stats``, ``log_table``,
  ``summarize_trace`` on a CPU profile of the port's own trace;
* the CLI: ``python -m magma_tpu_torch.train`` on a tiny yml runs its
  steps, logs JSONL (losses, eval loss, captions, image grid, VQA), saves,
  and resumes at the saved step; on v2's shape (two training directories,
  the eval set held out of both, GQA beside VQA) its split equals the JAX
  CLI's index for index.
"""

import importlib.util
import json
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from magma_tpu import evaluation as jeval
from magma_tpu import observability as jobs
from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.data.dataset import ImgCptDataset as JDataset
from magma_tpu.models.magma import Magma as JMagma
from magma_tpu_torch import evaluation as teval
from magma_tpu_torch import observability as tobs
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.data.dataset import ImgCptDataset as TDataset
from magma_tpu_torch.models.magma import Magma as TMagma

ROOT = Path(__file__).resolve().parents[1]
ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)
LM = dict(n_layers=2, n_heads=4, d_model=128, d_ff=512, rotary_dim=16, max_seq_len=128,
          attention_impl="xla")
LOSS_RTOL = 1e-4


def _write_dir(root, n, vqa, seed):
    (root / "images" / "0").mkdir(parents=True)
    (root / "image_data" / "0").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = [(48, 64), (64, 40), (70, 70)][i % 3]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / "0" / f"{i}.jpg")
        rec = {"image_path": f"images/0/{i}.jpg",
               "captions": [f"a picture number {i}", f"image {i} of a thing"]}
        if vqa:
            q = "what is it?" if i % 2 else f"which colour is the object number {i} here?"
            rec["metadata"] = {"question": q, "answers": ["thing"] * 3 + ["it"]}
        (root / "image_data" / "0" / f"{i}.json").write_text(json.dumps(rec))
    return root


def test_vqa_metric_equals_jax():
    answers = ["cat", "the Cat!", "cat", "dog", "a dog"]
    for pred in ("The cat.", "dog", "fish", "", "  a   DOG "):
        assert teval.normalize_answer(pred) == jeval.normalize_answer(pred)
        assert teval.vqa_accuracy(pred, answers) == jeval.vqa_accuracy(pred, answers)


def _kwargs():
    return dict(batch_size=2, train_steps=4, encoder_name="clip_resnet_large",
                adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
                use_image_embed_layernorm=True, image_embed_dropout_prob=0.1, image_size=64,
                lm_overrides=LM, compute_dtype="float32", param_dtype="float32",
                frozen_dtype="float32", attention_impl="xla")


@pytest.fixture(scope="module")
def models():
    jm = JMagma(JConfig(**_kwargs(), encoder_overrides=dict(ENC, compute_dtype=jnp.float32)),
                rng=0)
    r = np.random.default_rng(0)
    jm.params = jax.tree_util.tree_map(
        lambda a: a + r.standard_normal(a.shape).astype(np.float32) * 0.02, jm.params)
    jm.params["lm"]["wte"] = jm.params["lm"]["wte"].at[jm.lm_config.vocab_size:].set(0)
    tm = TMagma(TConfig(**_kwargs(), encoder_overrides=dict(ENC, compute_dtype=torch.float32)),
                device="cpu", init_weights=False)
    tm.params, tm.state = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params),
                                          jax.tree_util.tree_map(np.asarray, jm.state),
                                          tm.lm_config, tm.prefix_config)
    return jm, tm


def test_eval_vqa_answers_equal_jax(models, tmp_path, monkeypatch):
    """Seven questions of two prompt lengths in batches of 4: a ragged
    batch (right-padded with EOS, per-row prompt lengths) and a short last
    batch; then a subset drawn by the seed.  The byte-fallback tokenizer
    decodes random weights' tokens to empty text, so both decode a row to
    its ids here, and the answers compare the tokens themselves."""
    jm, tm = models
    for model in (jm, tm):
        monkeypatch.setattr(model.tokenizer, "_decode_ids",
                            lambda ids: " ".join(str(int(i)) for i in ids))
    vqa = _write_dir(tmp_path / "vqa", 7, True, 1)
    for kw in (dict(batch_size=4), dict(batch_size=3, n_samples=5, seed=2)):
        ref = jeval.eval_vqa(jm, str(vqa), max_steps=6, **kw)
        got = teval.eval_vqa(tm, str(vqa), max_steps=6, **kw)
        assert got["n"] == ref["n"] == kw.get("n_samples", 7)
        assert [a["question"] for a in got["answers"]] == [a["question"] for a in ref["answers"]]
        assert [a["pred"] for a in got["answers"]] == [a["pred"] for a in ref["answers"]]
        assert all(len(a["pred"].split()) == 6 for a in got["answers"])
        assert got["accuracy"] == ref["accuracy"]


def test_eval_loss_and_captions(models, tmp_path):
    jm, tm = models
    d = _write_dir(tmp_path / "data", 5, False, 2)
    jds = JDataset(d, jm.tokenizer, jm.transforms, seq_len=jm.seq_len)
    tds = TDataset(d, tm.tokenizer, tm.transforms, seq_len=tm.seq_len)
    random.seed(0)
    ref = jeval.eval_loss(jm, jds, n_batches=2, batch_size=3, seed=1)
    random.seed(0)
    got = teval.eval_loss(tm, tds, n_batches=2, batch_size=3, seed=1)
    assert np.isfinite(got) and got > 5  # untrained: about ln(vocab)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    caps = teval.eval_captions(tm, tds, n_samples=2, max_steps=3, temperature=0.0)
    assert len(caps) == 2 and {"pred", "refs"} <= set(caps[0]) and caps[0]["refs"]


def test_make_grid_equals_jax():
    imgs = np.random.default_rng(0).random((5, 3, 6, 7)).astype(np.float32)
    want = jobs.make_grid(imgs)
    np.testing.assert_array_equal(tobs.make_grid(imgs), want)
    np.testing.assert_array_equal(tobs.make_grid(torch.from_numpy(imgs), pad=2), want)


def test_memory_stats_and_log_table(capsys):
    if not torch.cuda.is_available():
        assert tobs.device_memory_stats() == {}
    tobs.log_table("vqa", ["a cat"], [["cat"]], 3)
    assert "[eval/vqa @ step 3]" in capsys.readouterr().out


def test_summarize_trace_on_a_cpu_profile(tmp_path):
    """The port's trace is torch.profiler's Chrome JSON; on the CPU it holds
    no device op, so the summary is of the host ops, largest first."""
    x = torch.randn(256, 256)
    with tobs.profile_trace(str(tmp_path)):
        for _ in range(3):
            x = torch.tanh(x @ x)
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    rows = tobs.summarize_trace(str(tmp_path), top=5)
    assert 0 < len(rows) <= 5 and {"plane", "line", "op", "total_ms", "count"} <= set(rows[0])
    assert all(r["plane"] == "host" for r in rows)
    assert [r["total_ms"] for r in rows] == sorted((r["total_ms"] for r in rows), reverse=True)
    mm = [r for r in tobs.summarize_trace(str(tmp_path), top=100) if r["op"] == "aten::mm"]
    assert mm and mm[0]["count"] == 3
    with pytest.raises(FileNotFoundError):
        tobs.summarize_trace(str(tmp_path / "none"))


def _cli_yml(tmp_path, train_steps, load, v2=False):
    """A tiny yml of v1's shape (one training directory, the eval set held
    out of it, VQA, checkpoints) or, with ``v2``, of v2's (normal mlp and
    attention adapters at k=8, ga 4, two training directories, the eval
    set held out of both, VQA and GQA, no checkpoint)."""
    d = tmp_path
    yml = d / f"tiny_{train_steps}{'_v2' if v2 else ''}.yml"
    if v2:
        adapters = ('{"mlp": {"adapter_type": "normal", "downsample_factor": 8}, '
                    '"attention": {"adapter_type": "normal", "downsample_factor": 8}}')
        shape = (f"gradient_accumulation_steps: 4, save: null, load: null, "
                 f"train_dataset_dir: ['{d}/train', '{d}/train2'], gqa_dir: '{d}/gqa',")
    else:
        adapters = '{"mlp": {"adapter_type": "normal", "downsample_factor": 4}}'
        load = f"'{d}/ckpt'" if load else "null"
        shape = (f"gradient_accumulation_steps: 2, save_every: 2, save: '{d}/ckpt', "
                 f"load: {load}, train_dataset_dir: '{d}/train',")
    yml.write_text(f"""{{
 encoder_name: 'clip_resnet_large', batch_size: 4, {shape}
 train_steps: {train_steps}, log_every: 1, eval_every: 2, eval_steps: 1,
 eval_dataset_dir: null, eval_dataset_pct: 0.25,
 vqa_dir: '{d}/vqa', image_size: 64, num_workers: 2, warmup_num_steps: 1,
 adapter_config: {adapters},
 use_image_embed_layernorm: true, image_embed_dropout_prob: 0.1,
 compute_dtype: 'float32', frozen_dtype: 'float32',
 lm_overrides: {{n_layers: 2, n_heads: 4, d_model: 128, d_ff: 512, rotary_dim: 16,
                 max_seq_len: 64, attention_impl: 'xla', remat: false}},
 encoder_overrides: {{width: 16, blocks: [1, 1, 1, 1], input_resolution: 64}},
}}""")
    return str(yml)


def _split_paths(train_ds, eval_ds):
    """The json path of every sample of a held-out split, in order: each
    subset's index into the concatenated training directories."""
    def path(concat, i):
        k = int(np.searchsorted(concat._offsets, i, side="right")) - 1
        return concat.datasets[k]._paths[i - int(concat._offsets[k])]

    return [[path(ds.dataset, i) for i in ds.indices] for ds in (train_ds, eval_ds)]


def test_train_cli_runs_logs_saves_and_resumes(tmp_path):
    """v1's shape: steps, logs, saves, resumes at the saved step.  Then v2's
    shape: its held-out split of two directories equals the JAX CLI's
    (root ``train.py``) index for index, and VQA and GQA accuracy are
    logged."""
    from magma_tpu_torch import train

    _write_dir(tmp_path / "train", 12, False, 3)
    _write_dir(tmp_path / "vqa", 3, True, 4)
    trainer = train.main(["--config", _cli_yml(tmp_path, 4, False), "--device", "cpu"])
    assert trainer.global_step == 4
    ckpt = tmp_path / "ckpt"
    assert (ckpt / "latest").read_text() == "step_4" and (ckpt / "step_2").is_dir()
    log = [json.loads(x) for x in (ckpt / "metrics.jsonl").read_text().splitlines()]
    train_rows = [m for m in log if "train/loss" in m]
    assert [m["step"] for m in train_rows] == [1, 2, 3, 4]
    assert all(np.isfinite(m["train/loss"]) and m["train/loader_wait"] >= 0 for m in train_rows)
    assert [m["step"] for m in log if "eval/loss" in m] == [2, 4]
    assert all("Caption 0" in m["inference/captions"] for m in log if "inference/captions" in m)
    grids = [m["inference/images"] for m in log if "inference/images" in m]
    assert len(grids) == 2 and all(Path(g).exists() for g in grids)
    assert len([m for m in log if "eval/vqa_accuracy" in m]) == 2

    resumed = train.main(["--config", _cli_yml(tmp_path, 6, True), "--device", "cpu"])
    assert resumed.global_step == 6
    log = [json.loads(x) for x in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in log if "train/loss" in m] == [1, 2, 3, 4, 5, 6]
    assert (ckpt / "latest").read_text() == "step_6"

    _write_dir(tmp_path / "train2", 7, False, 5)
    _write_dir(tmp_path / "gqa", 3, True, 6)
    yml = _cli_yml(tmp_path, 2, False, v2=True)
    spec = importlib.util.spec_from_file_location("jax_train_cli", ROOT / "train.py")
    jtrain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtrain)
    splits = [cli.get_pretraining_datasets(cfg.from_yml(yml), None, None, 64)
              for cli, cfg in ((jtrain, JConfig), (train, TConfig))]
    want, got = (_split_paths(*split) for split in splits)
    assert [len(x) for x in got] == [15, 4] and got == want
    assert [list(ds.indices) for ds in splits[1]] == [list(ds.indices) for ds in splits[0]]
    v2 = train.main(["--config", yml, "--device", "cpu", "--log-dir", str(tmp_path / "v2")])
    assert v2.global_step == 2 and v2.config.gradient_accumulation_steps == 4
    assert "adapter_attn" in v2.params["lm"]["blocks"]
    log = [json.loads(x) for x in (tmp_path / "v2" / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(m["train/loss"]) for m in log if "train/loss" in m)
    for qa in ("vqa", "gqa"):
        assert [m["step"] for m in log if f"eval/{qa}_accuracy" in m] == [2], qa


def test_train_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """--multihost refuses a half-set torchrun environment (multi-process
    runs are tests/test_torch_parallel_train.py's); the default device is
    the card, which raises without CUDA; the module runs as ``python -m
    magma_tpu_torch.train``."""
    from magma_tpu_torch import train

    yml = _cli_yml(tmp_path, 1, False)
    for k in ("LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="half set"):
        train.main(["--config", yml, "--multihost", "--device", "cpu"])
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--config", yml])
    out = subprocess.run([sys.executable, "-m", "magma_tpu_torch.train", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--config" in out.stdout
