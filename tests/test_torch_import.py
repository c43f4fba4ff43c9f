"""The port stands alone: it imports without jax, holds no jax import, and
loads the repository's configs as the JAX package does."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "magma_tpu_torch"


def test_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import magma_tpu_torch\n"
        "import magma_tpu_torch.models.magma, magma_tpu_torch.convert\n"
        "import magma_tpu_torch.ops.flash_attention, magma_tpu_torch.cuda_build\n"
        "import magma_tpu_torch.ops.quant, magma_tpu_torch.models.gptj\n"
        "import magma_tpu_torch.ops.decode_layer\n"
        "import magma_tpu_torch.training\n"
        "import magma_tpu_torch.training.train_loop, magma_tpu_torch.training.checkpoint\n"
        "import magma_tpu_torch.models.clip_vit, magma_tpu_torch.models.nfnet\n"
        "import magma_tpu_torch.models.classifier, magma_tpu_torch.train\n"
        "import magma_tpu_torch.data.dataset, magma_tpu_torch.data.convert\n"
        "import magma_tpu_torch.data.loader, magma_tpu_torch.data.transforms\n"
        "import magma_tpu_torch.native, magma_tpu_torch.evaluation\n"
        "import magma_tpu_torch.observability\n"
        "import magma_tpu_torch.parallel, magma_tpu_torch.parallel.ring_attention\n"
        "import magma_tpu_torch.parallel.sp_decode, magma_tpu_torch.parallel.sharding\n"
        "assert not [m for m in sys.modules if m == 'magma_tpu' or m.startswith('magma_tpu.')]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_jax_import_in_the_source():
    pat = re.compile(r"^\s*(import\s+(jax|flax|magma_tpu)\b|from\s+(jax|flax|magma_tpu)[\s.])",
                     re.M)
    sources = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in sources for m in pat.finditer(p.read_text())]
    assert not hits, hits
    for kernel in ("flash_attn_fwd.cu", "int8_matmul.cu", "fused_adapter.cu", "int4_matmul.cu",
                   "boundary.cu", "decode_layer.cu", "flash_attn_bwd.cu", "int8_matmul_dx.cu"):
        assert (PORT / "csrc" / kernel).exists()


@pytest.mark.parametrize("name", ["MAGMA_v1", "MAGMA_v2"])
def test_configs_load_like_the_jax_package(name):
    from magma_tpu.config import MultimodalConfig as JConfig
    from magma_tpu_torch.config import MultimodalConfig as TConfig

    path = ROOT / "configs" / f"{name}.yml"
    j, t = JConfig.from_yml(path), TConfig.from_yml(path)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    jd.pop("name"), td.pop("name")  # a random id when the yml names none
    assert jd == td
    assert t.encoder_name == "clip_resnet_large" and t.attention_impl == "flash"


def test_v1_config_builds_the_6b_geometry():
    from magma_tpu_torch.models.magma import build_lm_config, build_prefix_config
    from magma_tpu_torch.config import MultimodalConfig

    cfg = MultimodalConfig.from_yml(ROOT / "configs" / "MAGMA_v1.yml")
    lm = build_lm_config(cfg)
    assert (lm.n_layers, lm.n_heads, lm.d_model, lm.d_ff, lm.rotary_dim) == (28, 16, 4096, 16384, 64)
    assert (lm.head_dim, lm.vocab_size, lm.padded_vocab_size) == (256, 50258, 50304)
    assert lm.mlp_adapter.adapter_type == "normal" and lm.attn_adapter is None
    assert lm.attention_impl == "flash"
    ip = build_prefix_config(cfg, lm)
    assert (ip.out_seq_len, ip.input_resolution, ip.use_layernorm) == (144, 384, True)


def test_tokenizer_id_space():
    from magma_tpu_torch.tokenizer import ByteFallbackTokenizer

    tok = ByteFallbackTokenizer()
    assert (tok.eos_token_id, tok.cls_token_id, len(tok)) == (50256, 50257, 50258)
    assert tok.decode(tok.encode("Describe the painting:")[0]) == "Describe the painting:"


# the JAX package's top-level names, eager and lazy (magma_tpu/__init__.py)
JAX_NAMES = ("MultimodalConfig", "load_config", "get_tokenizer", "count_parameters", "is_main",
             "print_main", "cycle", "Magma", "MagmaClassifier", "Trainer", "ImageInput",
             "ImgCptDataset", "collate_fn", "convert_dataset", "BatchLoader", "make_mesh",
             "get_transforms", "load_pretrained_encoder", "LMServingEngine",
             "MagmaServingEngine")


def test_the_jax_package_names_resolve_with_jax_blocked():
    import magma_tpu

    assert set(JAX_NAMES) == set(magma_tpu.__all__) | set(magma_tpu._LAZY)
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import magma_tpu_torch as m\n"
        f"for name in {JAX_NAMES!r}: assert callable(getattr(m, name)), name\n"
        f"assert set(m.__all__) >= set({JAX_NAMES!r})\n"
        "from magma_tpu_torch.data import ImgCptDataset, collate_fn, convert_dataset, ImageInput\n"
        "from magma_tpu_torch.ops.preprocess import preprocess_uint8_batch\n"
        "assert not [m for m in sys.modules if m == 'magma_tpu' or m.startswith('magma_tpu.')]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_preprocess_uint8_batch_matches_jax(monkeypatch):
    """numpy uint8 NHWC -> float32 NCHW on the asked device, against the JAX
    package's (its atol: tests/test_torch_vision.py); the card by default,
    which raises without CUDA."""
    import numpy as np
    import torch

    from magma_tpu.ops.preprocess import preprocess_uint8_batch as jax_batch
    from magma_tpu_torch.ops.preprocess import preprocess_uint8_batch

    images = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    out = preprocess_uint8_batch(images, 64, device="cpu")
    assert out.shape == (2, 3, 64, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_batch(images, 64)), atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess_uint8_batch(images, 64)
