"""The port's tracer (``magma_tpu_torch.observability``: ``span``, ``count``,
``tracing``, ``take``, ``export_chrome_trace``) on the CPU: off, it records
nothing and enters no ``record_function``; on, spans nest with their
parent's and root's ids and attrs, counters add host integers, and under a
``torch.profiler`` capture every span lies in the profiler's trace on the
same clock; the spans and counters of a tiny ``Magma.generate`` (both
decode paths) and ``Trainer.train_step``; the train CLI's ``--trace``."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from magma_tpu_torch import observability as obs
from magma_tpu_torch.config import MultimodalConfig
from magma_tpu_torch.models.magma import Magma
from magma_tpu_torch.ops import sampling


@pytest.fixture(autouse=True)
def _empty():
    obs.take()
    yield
    obs.take()


def _names(spans):
    return [s.name for s in spans]


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def _raise(*a, **k):
    raise AssertionError("record_function entered with the profiler off")


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not obs.enabled()
    first = obs.span("lm.prefill", positions=64)
    assert obs.span("lm.sample") is first  # one shared no-op
    with first:
        with obs.span("lm.sample"):
            obs.count("lm.decode_steps")
            obs.count("lm.decode_steps", torch.ones(()))  # not even looked at when off
    assert obs.take() == ([], {})
    with obs.tracing():  # on, but no profiler: still no record_function
        with obs.span("lm.sample"):
            pass
    spans, _ = obs.take()
    assert _names(spans) == ["lm.sample"]


def test_nesting_ids_attrs_counters_and_take_clears():
    with obs.tracing():
        assert obs.enabled()
        with obs.span("train.step", step=3):
            for i in range(2):
                with obs.span("train.micro", i=i):
                    with obs.span("train.forward"):
                        obs.count("train.micro_batches")
            obs.count("train.samples", np.int64(8))
            with pytest.raises(TypeError):
                obs.count("train.samples", torch.tensor(8))
        with obs.span("train.step", step=4):
            pass
    assert not obs.enabled()
    with obs.span("train.step"):  # off again
        obs.count("train.samples")
    spans, counters = obs.take()
    assert counters == {"train.micro_batches": 2, "train.samples": 8}
    # kept in the order they ended
    assert _names(spans) == ["train.forward", "train.micro", "train.forward", "train.micro",
                             "train.step", "train.step"]
    step, step2 = _by_name(spans, "train.step")
    assert step.attrs == {"step": 3} and step2.attrs == {"step": 4}
    assert step.parent is None and step.root == step.id
    assert step2.root == step2.id != step.root
    micros = _by_name(spans, "train.micro")
    assert [m.attrs for m in micros] == [{"i": 0}, {"i": 1}]
    for m, f in zip(micros, _by_name(spans, "train.forward")):
        assert m.parent == step.id and f.parent == m.id
        assert m.root == f.root == step.id
        assert step.start_ns <= m.start_ns <= f.start_ns <= f.end_ns <= m.end_ns <= step.end_ns
    assert len({s.id for s in spans}) == len(spans)
    assert obs.take() == ([], {})


def test_spans_lie_in_a_cpu_profile_on_its_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.enabled()
        with obs.span("lm.generate", b=1):
            with obs.span("lm.prefill"):
                x = torch.tanh(x @ x)
            for step in range(3):
                with obs.span("lm.decode_step", step=step):
                    with obs.span("lm.sample"):
                        x = torch.softmax(x, -1)
                    obs.count("lm.decode_steps")
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans, counters = obs.take()
    assert counters == {"lm.decode_steps": 3}
    assert sorted(_names(spans)) == sorted(e["name"] for e in ranges)
    # each span against the range of its name and rank, within 5 ms
    for name in set(_names(spans)):
        mine = sorted(_by_name(spans, name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in ranges if e["name"] == name), key=lambda e: e["ts"])
        for s, e in zip(mine, theirs):
            assert abs(base + e["ts"] * 1e3 - s.start_ns) < 5e6, name
            assert abs(base + (e["ts"] + e["dur"]) * 1e3 - s.end_ns) < 5e6, name
            assert s.thread == e["tid"], name  # the same row in a merged trace
    # the same nesting in the profiler's ranges
    outer = next(e for e in ranges if e["name"] == "lm.generate")
    for e in ranges:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    steps = [e for e in ranges if e["name"] == "lm.decode_step"]
    for e in (e for e in ranges if e["name"] == "lm.sample"):
        assert any(d["ts"] <= e["ts"] and e["ts"] + e["dur"] <= d["ts"] + d["dur"]
                   for d in steps)
    generate = _by_name(spans, "lm.generate")[0]
    assert all(s.root == generate.id for s in spans)


def _tiny_magma():
    cfg = MultimodalConfig(
        batch_size=4, train_steps=2, gradient_accumulation_steps=2, warmup_num_steps=1,
        encoder_name="clip_resnet_large",
        adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
        use_image_embed_layernorm=True, image_size=64, compute_dtype="float32",
        frozen_dtype="float32",
        lm_overrides=dict(n_layers=2, n_heads=4, d_model=128, d_ff=512, rotary_dim=16,
                          max_seq_len=128, attention_impl="xla", remat=False),
        encoder_overrides=dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64))
    return Magma(cfg, seed=0, device="cpu")


def test_generate_spans_and_counters():
    model = _tiny_magma()
    g = torch.Generator().manual_seed(0)
    image = torch.rand((1, 3, 64, 64), generator=g)
    with obs.tracing():
        emb = model.preprocess_inputs([image, np.array([[10, 11, 12, 13, 14]])])
        s = emb.shape[1]
        timing = {}
        tokens = model.generate(emb, max_steps=5, temperature=0.0, decode=False,
                                timing=timing)
    spans, counters = obs.take()
    steps = timing["steps"]
    assert tokens.shape == (1, 5) and 1 <= steps <= 5
    assert len(_by_name(spans, "lm.prefill")) == 1
    assert len(_by_name(spans, "lm.decode_step")) == counters["lm.decode_steps"] == steps
    assert len(_by_name(spans, "lm.sample")) == steps
    assert len(_by_name(spans, "lm.decode_forward")) == steps - 1
    assert counters["lm.prompt_positions"] == s
    assert counters["lm.prefill_positions"] == -(-s // 64) * 64
    # the eos checks, and the tokens' copy to the host (the CPU's timing waits for nothing)
    assert counters["lm.host_reads"] == len(_by_name(spans, "lm.eos_check")) + 1
    assert len(_by_name(spans, "magma.to_host")) == 1
    embed = _by_name(spans, "magma.embed")[0]
    assert embed.attrs == {"images": 1}
    assert _by_name(spans, "vision.prefix")[0].parent == embed.id
    assert len(_by_name(spans, "magma.preprocess")) == 1
    generate = _by_name(spans, "lm.generate")[0]
    assert generate.attrs == {"b": 1, "positions": -(-s // 64) * 64}
    for s_ in spans:
        if s_.name.startswith("lm.") and s_.name != "lm.generate":
            assert s_.root == generate.id


def test_split_generate_spans_and_counters():
    model = _tiny_magma()
    emb = torch.randn((2, 80, 128), generator=torch.Generator().manual_seed(1))
    with obs.tracing():
        tokens, steps = sampling.generate_tokens_split(
            model.lm_config, model.params["lm"], emb, max_steps=4, temperature=0.0,
            prompt_len=torch.tensor([80, 50]), window=2, prefill_chunk=32)
    spans, counters = obs.take()
    assert tokens.shape == (2, 4)
    assert len(_by_name(spans, "lm.prefill")) == 1
    chunks = _by_name(spans, "lm.prefill_chunk")
    assert [c.attrs for c in chunks] == [{"chunk": i} for i in range(3)]
    assert all(c.parent == _by_name(spans, "lm.prefill")[0].id for c in chunks)
    assert counters["lm.prefill_positions"] == 2 * 3 * 32
    assert counters["lm.prompt_positions"] == 130
    assert counters["lm.decode_steps"] == len(_by_name(spans, "lm.decode_step")) == steps
    assert counters["lm.host_reads"] == len(_by_name(spans, "lm.eos_check")) == steps // 2


def test_train_step_spans_and_counters():
    from magma_tpu_torch.training.train_loop import Trainer

    model = _tiny_magma()
    trainer = Trainer(model, model.config)
    g = torch.Generator().manual_seed(0)
    images = torch.randn((4, 3, 64, 64), generator=g)
    captions = torch.full((4, 128), 50256, dtype=torch.long)
    captions[:, :10] = torch.randint(0, 50000, (4, 10), generator=g)
    with obs.tracing():
        loss = trainer.train_step(images, captions)
    spans, counters = obs.take()
    assert np.isfinite(loss)
    assert counters == {"train.samples": 4, "train.micro_batches": 2,
                        "optim.tensors": len(trainer.trainable)}
    step = _by_name(spans, "train.step")
    assert len(step) == 1 and step[0].attrs == {"step": 0}
    micros = _by_name(spans, "train.micro")
    assert [m.attrs for m in micros] == [{"i": 0}, {"i": 1}]
    assert all(m.parent == step[0].id for m in micros)
    for name in ("train.forward", "train.backward"):
        assert sorted(s.parent for s in _by_name(spans, name)) == sorted(m.id for m in micros)
    # one add a micro-batch, then the mean's cast
    assert len(_by_name(spans, "train.accumulate")) == 3
    for name in ("train.batch", "train.optimizer", "train.loss_read"):
        assert len(_by_name(spans, name)) == 1 and _by_name(spans, name)[0].parent == step[0].id
    assert not _by_name(spans, "train.reduce")  # no mesh to reduce over


def test_export_chrome_trace_loads_back(tmp_path):
    with obs.tracing():
        with obs.span("train.step", step=1):
            with obs.span("train.optimizer"):
                obs.count("optim.tensors", 5)
    spans, counters = obs.take()
    path = tmp_path / "spans.json"
    obs.export_chrome_trace(str(path), spans, counters)
    events = json.loads(path.read_text())["traceEvents"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(xs) == {"train.step", "train.optimizer"}
    for s in spans:
        e = xs[s.name]
        assert e["ts"] == s.start_ns / 1e3 and abs(e["dur"] - (s.end_ns - s.start_ns) / 1e3) < 1e-3
        assert e["args"]["id"] == s.id and e["args"]["parent"] == s.parent
    assert xs["train.step"]["args"]["step"] == 1
    assert [(e["name"], e["args"]) for e in events if e["ph"] == "C"] == [
        ("optim.tensors", {"optim.tensors": 5})]


def test_train_cli_trace_writes_spans(tmp_path):
    from magma_tpu_torch import train

    rng = np.random.default_rng(0)
    (tmp_path / "train" / "images" / "0").mkdir(parents=True)
    (tmp_path / "train" / "image_data" / "0").mkdir(parents=True)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
            tmp_path / "train" / "images" / "0" / f"{i}.jpg")
        (tmp_path / "train" / "image_data" / "0" / f"{i}.json").write_text(json.dumps(
            {"image_path": f"images/0/{i}.jpg", "captions": [f"a picture number {i}"]}))
    yml = tmp_path / "tiny.yml"
    yml.write_text(f"""{{
 encoder_name: 'clip_resnet_large', batch_size: 2, gradient_accumulation_steps: 2,
 train_steps: 2, log_every: 1, eval_every: 100, save: null, load: null,
 train_dataset_dir: '{tmp_path}/train', eval_dataset_dir: null, eval_dataset_pct: 0.25,
 image_size: 64, num_workers: 1, warmup_num_steps: 1,
 adapter_config: {{"mlp": {{"adapter_type": "normal", "downsample_factor": 4}}}},
 compute_dtype: 'float32', frozen_dtype: 'float32',
 lm_overrides: {{n_layers: 2, n_heads: 4, d_model: 128, d_ff: 512, rotary_dim: 16,
                 max_seq_len: 64, attention_impl: 'xla', remat: false}},
 encoder_overrides: {{width: 16, blocks: [1, 1, 1, 1], input_resolution: 64}},
}}""")
    trainer = train.main(["--config", str(yml), "--device", "cpu", "--trace",
                          "--log-dir", str(tmp_path / "log")])
    assert trainer.global_step == 2 and not obs.enabled()
    events = json.loads((tmp_path / "log" / "spans_rank0.json").read_text())["traceEvents"]
    assert [e["args"]["step"] for e in events if e["name"] == "train.step"] == [0, 1]
    assert sum(e["name"] == "train.micro" for e in events) == 4
    counters = {e["name"]: e["args"][e["name"]] for e in events if e["ph"] == "C"}
    assert counters["train.samples"] == 4 and counters["train.micro_batches"] == 4
