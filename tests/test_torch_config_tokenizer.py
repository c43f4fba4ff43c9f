"""The port's config and tokenizer against the JAX package's contract tests
(``tests/test_config.py``, ``tests/test_tokenizer.py``), on the CPU.

Each test runs the JAX test's checks against ``magma_tpu_torch/config.py``
and ``magma_tpu_torch/tokenizer.py`` and, where the two packages can be
given the same input, holds the port's result equal to JAX's.  The
configs are the repository's ``configs/MAGMA_v{1,2}.yml``.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from magma_tpu import tokenizer as jtok
from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu_torch import tokenizer as ttok
from magma_tpu_torch.config import MultimodalConfig as TConfig

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_defaults_and_post_init():
    cfg = TConfig(batch_size=8, train_steps=100)
    assert cfg.lr_scheduler == "WarmupLR"
    assert cfg.adapter_config == {}
    assert cfg.is_classifier is False
    assert cfg.name is not None and len(cfg.name) == 8
    assert cfg.seq_len is None
    d = cfg.to_dict()
    assert d["batch_size"] == 8 and "lr_scheduler" in d
    want = JConfig(batch_size=8, train_steps=100).to_dict()
    assert d.keys() == want.keys()
    assert {k: v for k, v in d.items() if k != "name"} == \
        {k: v for k, v in want.items() if k != "name"}


def test_classifier_flag():
    cfg = TConfig(batch_size=1, train_steps=1, class_dict={"num_classes": 3})
    assert cfg.is_classifier is True
    assert JConfig(batch_size=1, train_steps=1, class_dict={"num_classes": 3}).is_classifier


def test_loads_the_repository_v1():
    cfg = TConfig.from_yml(CONFIGS / "MAGMA_v1.yml")
    assert cfg.encoder_name == "clip_resnet_large"
    assert (cfg.batch_size, cfg.train_steps, cfg.gradient_accumulation_steps) == (256, 150000, 8)
    assert (cfg.lr, cfg.image_enc_lr, cfg.image_size) == (8.0e-4, 2.0e-6, 384)
    assert cfg.use_image_embed_layernorm is True and cfg.image_embed_dropout_prob == 0.1
    assert cfg.adapter_config == {"mlp": {"adapter_type": "normal", "downsample_factor": 4}}
    assert cfg.lr_scheduler == "WarmupDecayLR"  # lr_decay_iters is set


def test_loads_the_repository_v2():
    cfg = TConfig.from_yml(CONFIGS / "MAGMA_v2.yml")
    assert cfg.adapter_config["attention"] == {"adapter_type": "normal", "downsample_factor": 8}
    assert isinstance(cfg.train_dataset_dir, list)
    assert cfg.eval_dataset_dir is None


def test_padding_to_max_length():
    out = ttok.ByteFallbackTokenizer(64).encode("hi", max_length=10, padding="max_length")
    assert out.shape == (1, 10) and out.dtype == np.int32
    assert list(out[0, 2:]) == [50256] * 8  # right-padded with eos
    np.testing.assert_array_equal(
        out, jtok.ByteFallbackTokenizer(64).encode("hi", max_length=10, padding="max_length"))


def test_truncation():
    kw = dict(max_length=4, padding="max_length", truncation=True)
    out = ttok.ByteFallbackTokenizer(64).encode("hello world", **kw)
    assert out.shape == (1, 4)
    np.testing.assert_array_equal(out, jtok.ByteFallbackTokenizer(64).encode("hello world", **kw))


def test_decode_strips_special_tokens():
    ids = [72, 105, 50257, 50256, 65]  # "Hi" + image + eos + "A"
    assert ttok.ByteFallbackTokenizer(64).decode(ids) == "HiA"
    assert ttok.ByteFallbackTokenizer(64).batch_decode([ids, ids[:2]]) == ["HiA", "Hi"]


def test_unknown_name_raises():
    with pytest.raises(ValueError):
        ttok.get_tokenizer("llama")


# a miniature GPT-2-format vocab (the full files are not in the repository;
# the loading, merge and special-token logic is the same at any size)
MINI_VOCAB = {"<|endoftext|>": 0, "h": 1, "e": 2, "l": 3, "o": 4, "Ġ": 5,
              "he": 6, "ll": 7, "hell": 8}
MINI_MERGES = "#version: 0.2\nh e\nl l\nhe ll\n"


def _write_mini_bpe(d):
    (d / "vocab.json").write_text(json.dumps(MINI_VOCAB))
    (d / "merges.txt").write_text(MINI_MERGES)
    return str(d / "vocab.json"), str(d / "merges.txt")


def test_bpe_loading_path_with_mini_vocab(tmp_path):
    vocab, merges = _write_mini_bpe(tmp_path)
    tok = ttok.get_tokenizer("gpt2", sequence_length=32, vocab_file=vocab, merges_file=merges)
    assert isinstance(tok, ttok.GPT2BPETokenizer)
    assert tok.eos_token_id == 0
    assert tok.image_token_id == len(MINI_VOCAB) == tok.cls_token_id
    assert tok.pad_token_id == tok.eos_token_id
    ids = tok.encode("hello hello")  # the merges apply
    assert ids.shape[0] == 1 and ids.dtype.name == "int32"
    assert list(ids[0]) == [8, 4, 5, 8, 4]
    padded = tok.encode("hello", max_length=8, padding="max_length")
    assert padded.shape == (1, 8)
    assert list(padded[0][2:]) == [tok.eos_token_id] * 6
    row = [tok.image_token_id] * 2 + list(padded[0])
    assert tok.decode(row) == "hello"
    assert tok.batch_decode([row, row]) == ["hello", "hello"]
    ref = jtok.get_tokenizer("gpt2", sequence_length=32, vocab_file=vocab, merges_file=merges)
    for text in ("hello hello", "oh hello, hell"):
        np.testing.assert_array_equal(tok.encode(text), ref.encode(text))


def test_bpe_env_dir_resolution(tmp_path, monkeypatch):
    _write_mini_bpe(tmp_path)
    monkeypatch.setenv("MAGMA_TPU_GPT2_DIR", str(tmp_path))
    tok = ttok.get_tokenizer("gpt2", sequence_length=16)
    assert isinstance(tok, ttok.GPT2BPETokenizer)
    assert tok.model_max_length == 16


def test_byte_fallback_warns_and_strict_raises(tmp_path, monkeypatch):
    """The byte fallback never engages silently: it warns by default and
    raises under strict=True (``MultimodalConfig.strict_tokenizer``)."""
    monkeypatch.delenv("MAGMA_TPU_GPT2_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HOME", str(tmp_path))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tok = ttok.get_tokenizer("gpt2", sequence_length=64)
    assert isinstance(tok, ttok.ByteFallbackTokenizer)
    assert any("MAGMA_TPU_GPT2_DIR" in str(w.message) for w in rec)
    with pytest.raises(FileNotFoundError, match="GPT-2 BPE"):
        ttok.get_tokenizer("gpt2", sequence_length=64, strict=True)
