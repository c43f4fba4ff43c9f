"""The port's data path against the JAX package's: the transforms, the
native decoder, the dataset and its helpers, the converter and the batch
loader, on the same files and seeds.

Tolerances: the CLIP preprocess within 1e-5 (the two resize kernels agree
to ~1e-6 on [0, 1] pixels, scaled up about fourfold by the CLIP std, as in
test_torch_vision.py); everything else exactly (the same PIL and numpy
operations, the same draws from Python's ``random`` and numpy's
``RandomState``, the same C++ source for the native decoder).
"""

import json
import random
import time

import numpy as np
import pytest
import torch
from PIL import Image

from magma_tpu import native as jnative
from magma_tpu.data import convert as jconvert
from magma_tpu.data import dataset as jds
from magma_tpu.data import transforms as jtf
from magma_tpu.data.loader import BatchLoader as JLoader
from magma_tpu.tokenizer import ByteFallbackTokenizer as JTok
from magma_tpu_torch import native as tnative
from magma_tpu_torch.data import convert as tconvert
from magma_tpu_torch.data import dataset as tds
from magma_tpu_torch.data import transforms as ttf
from magma_tpu_torch.data.loader import BatchLoader as TLoader
from magma_tpu_torch.tokenizer import ByteFallbackTokenizer as TTok

CLIP_ATOL = 1e-5
SIZES = [(48, 80), (80, 48), (20, 30), (64, 64), (33, 100)]


def _pil(h, w, seed):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                                dtype=np.uint8))


@pytest.mark.parametrize("use_pad", [False, True], ids=["crop", "pad"])
def test_clip_transform_matches_jax(use_pad):
    for i, (h, w) in enumerate(SIZES):
        img = _pil(h, w, i)
        ref = jtf.clip_transform(32, use_pad=use_pad)(img)
        out = ttf.host_clip_transform(32, use_pad=use_pad)(img)
        assert isinstance(out, np.ndarray) and out.shape == ref.shape == (1, 3, 32, 32)
        np.testing.assert_allclose(out, ref, atol=CLIP_ATOL)


@pytest.mark.parametrize("extra", [False, True], ids=["plain", "color_jitter"])
def test_train_transform_matches_jax_under_the_same_seed(extra):
    """RandCropResize, color jitter and the flip draw from Python's random
    in the JAX package's order: the same seed gives the same array, for
    images smaller than the target (padded) and larger."""
    for i, (h, w) in enumerate(SIZES):
        img = _pil(h, w, 10 + i)
        random.seed(i)
        ref = jtf.train_transform(40, extra)(img)
        ref_next = random.random()
        random.seed(i)
        out = ttf.train_transform(40, extra)(img)
        assert random.random() == ref_next  # the same number of draws
        assert out.shape == ref.shape == (1, 3, 40, 40)
        np.testing.assert_array_equal(out, ref)


def test_get_transforms_paths(monkeypatch):
    """CLIP: the card's preprocess with a device (here the CPU), the host
    path without one (native when it builds, else PIL; native=True raises
    when it does not build); other encoders: the random-crop pipeline."""
    img = _pil(48, 80, 0)
    dev_fn = ttf.get_transforms(64, "clip", input_resolution=32, device="cpu")
    assert isinstance(dev_fn(img), torch.Tensor)
    host = ttf.get_transforms(64, "clip_resnet_large", input_resolution=32)
    assert isinstance(host, tnative.NativeClipTransform) == tnative.available()
    assert ttf.get_transforms(64, "clip", input_resolution=32, native=False)(img).shape == (
        1, 3, 32, 32)
    assert ttf.get_transforms(64, "nfresnet50")(img).shape == (1, 3, 64, 64)
    with pytest.raises(ValueError):
        ttf.get_transforms(64, "clip", input_resolution=32, native=True, device="cpu")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", "no toolchain")
    with pytest.raises(RuntimeError, match="no toolchain"):
        ttf.get_transforms(64, "clip", input_resolution=32, native=True)
    assert not isinstance(ttf.get_transforms(64, "clip", input_resolution=32),
                          tnative.NativeClipTransform)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i, (h, w) in enumerate(SIZES):
        p = d / f"{i}.jpg"
        _pil(h, w, 20 + i).save(p, quality=90)
        paths.append(p)
    png = d / "x.png"
    _pil(30, 40, 99).save(png)
    return paths + [png]


def test_native_decoder_matches_jax_native(jpegs):
    """The port's copy of loader.cc, built into build/native/, gives JAX's
    native bits: decode and the CLIP preprocess, JPEG and PNG; a PIL image
    goes through the host PIL path."""
    if not (jnative.available() and tnative.available()):
        pytest.fail(f"native loader did not build: {tnative.build_error()}")
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")
    for p in jpegs:
        np.testing.assert_array_equal(tnative.decode(p), jnative.decode(p))
        np.testing.assert_array_equal(tnative.load_clip(p, 32), jnative.load_clip(p, 32))
        np.testing.assert_array_equal(tnative.NativeClipTransform(32)(p),
                                      jnative.NativeClipTransform(32)(p))
    img = Image.open(jpegs[0])
    np.testing.assert_array_equal(tnative.NativeClipTransform(32)(img),
                                  ttf.host_clip_transform(32)(img))
    bad = jpegs[0].parent / "bad.jpg"
    bad.write_bytes(b"not an image")
    with pytest.raises(IOError):
        tnative.load_clip(bad, 32)


def _identity_transform(img):
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return arr.transpose(2, 0, 1)[None]


@pytest.fixture()
def dataset_dir(tmp_path):
    """The standard layout with a record that names no image_path (its image
    found by the json's stem), a corrupt image and an unreadable json."""
    (tmp_path / "images" / "0").mkdir(parents=True)
    (tmp_path / "image_data" / "0").mkdir(parents=True)
    for i in range(8):
        _pil(16 + i, 20, 30 + i).save(tmp_path / "images" / "0" / f"{i}.jpg")
        rec = {"captions": [f"caption number {i}", f"alt caption {i}", f"third {i}"],
               "metadata": {}}
        if i != 3:
            rec["image_path"] = f"images/0/{i}.jpg"
        (tmp_path / "image_data" / "0" / f"{i}.json").write_text(json.dumps(rec))
    (tmp_path / "images" / "0" / "5.jpg").write_bytes(b"corrupt")
    (tmp_path / "image_data" / "0" / "6.json").write_text("{not json")
    return tmp_path


@pytest.mark.parametrize("in_memory", [False, True], ids=["lazy", "in_memory"])
def test_dataset_items_equal_jax(dataset_dir, in_memory):
    """Every item, under the same seed: the caption drawn, its tokens, the
    pixels, the sibling-jpg inference and the redraws after the corrupt
    image and the unreadable json."""
    ref = jds.ImgCptDataset(dataset_dir, JTok(24), _identity_transform, seq_len=24,
                            load_data_in_memory=in_memory)
    got = tds.ImgCptDataset(dataset_dir, TTok(24), _identity_transform, seq_len=24,
                            load_data_in_memory=in_memory)
    assert len(got) == len(ref) == (7 if in_memory else 8)
    for i in range(len(ref)):
        random.seed(i)
        r_img, r_cap = ref[i]
        random.seed(i)
        t_img, t_cap = got[i]
        np.testing.assert_array_equal(t_img, r_img)
        np.testing.assert_array_equal(t_cap, r_cap)
        assert t_cap.shape == (1, 24) and t_cap.dtype == np.int32


def test_concat_split_and_collate_equal_jax(dataset_dir):
    def both(mod, tok):
        a = mod.ImgCptDataset(dataset_dir, tok(24), _identity_transform, seq_len=24)
        b = mod.ImgCptDataset(dataset_dir, tok(24), lambda img: _identity_transform(
            img.resize((16, 16))), seq_len=24)
        cat = mod.ConcatDataset([a, b])
        train, held = mod.random_split(cat, [12, 4], seed=3)
        random.seed(0)
        batch = mod.collate_fn([b[i] for i in (0, 2, 4)], seq_len=20)
        return cat, train, held, batch

    rcat, rtrain, rheld, rbatch = both(jds, JTok)
    tcat, ttrain, theld, tbatch = both(tds, TTok)
    assert len(tcat) == len(rcat) == 16
    assert list(ttrain.indices) == list(rtrain.indices)
    assert list(theld.indices) == list(rheld.indices)
    random.seed(1)
    r = rcat[11]
    random.seed(1)
    t = tcat[11]
    np.testing.assert_array_equal(t[0], r[0])
    for t_arr, r_arr in zip(tbatch, rbatch):
        np.testing.assert_array_equal(t_arr, r_arr)
    assert tbatch[0].shape == (3, 3, 16, 16) and tbatch[1].shape == (3, 20)


def _tree(root):
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = str(p.relative_to(root))
            out[rel] = json.loads(p.read_text()) if p.suffix == ".json" else p.read_bytes()
    return out


def test_convert_dataset_tree_equals_jax(tmp_path):
    """Shards of 2, a repeated source (stored once, its hash reused), a
    missing image (its samples skipped): the same files, bytes and records."""
    src = tmp_path / "src"
    src.mkdir()
    items = []
    for i in range(5):
        p = src / f"pic{i}.jpg"
        _pil(12, 12, 50 + i).save(p)
        items.append((p, {"captions": [f"c{i}"], "metadata": {"i": i}}))
    items.insert(2, (src / "pic0.jpg", {"captions": ["again"], "metadata": {}}))
    items.insert(4, (src / "missing.jpg", {"captions": ["gone"], "metadata": {}}))
    trees = []
    for mod, name in ((jconvert, "jax"), (tconvert, "port")):
        out = tmp_path / name
        mod.convert_dataset(out, dir_size=2, mode="cp", hash_fn=lambda img: img.size[0] * 7,
                            ds_iterator=list(items))
        trees.append(_tree(out))
    assert trees[0] == trees[1]
    assert len([k for k in trees[1] if k.endswith(".json")]) == 6
    assert len([k for k in trees[1] if k.endswith(".jpg")]) == 5


class _FakeDS:
    def __init__(self, n=24):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((1, 3, 4, 4), i, np.float32), np.full((1, 8), i, np.int32)


@pytest.mark.parametrize("flat", [False, True], ids=["ga_layout", "flat"])
def test_batch_loader_batches_equal_jax(flat):
    """The same seed gives the same batches, in (ga, micro, ...) or flat
    layout, as host tensors (not pinned for the CPU)."""
    kw = dict(batch_size=6, gradient_accumulation_steps=2, seq_len=6, num_workers=2, seed=4,
              flat=flat)
    ref, got = JLoader(_FakeDS(), **kw), TLoader(_FakeDS(), device="cpu", **kw)
    try:
        for _ in range(5):  # past one epoch of 24 samples
            (ri, rc), (ti, tc) = next(ref), next(got)
            assert isinstance(ti, torch.Tensor) and not ti.is_pinned()
            assert ti.shape == ri.shape == ((6, 3, 4, 4) if flat else (2, 3, 3, 4, 4))
            assert tc.shape == rc.shape and tc.dtype == torch.int32
            np.testing.assert_array_equal(ti.numpy(), ri)
            np.testing.assert_array_equal(tc.numpy(), rc)
    finally:
        ref.close()
        got.close()


def test_batch_loader_slow_consumer_drops_nothing():
    """A full prefetch queue makes the producer wait: with shuffle off the
    consumed batches stay in dataset order (tests/test_trainer.py's case)."""
    loader = TLoader(_FakeDS(64), batch_size=4, gradient_accumulation_steps=1, seq_len=8,
                     num_workers=2, shuffle=False, prefetch=1, device="cpu")
    time.sleep(2.0)  # let the producer build ahead and meet a full queue
    seen = []
    for _ in range(4):
        _, captions = next(loader)
        seen.extend(captions[0, :, 0].tolist())
    loader.close()
    assert seen == list(range(16)), f"batches dropped or reordered: {seen}"


def test_batch_loader_targets_the_card_by_default():
    """The default target is CUDA: without it the loader raises, as the
    port's entry points do; a bad layout raises before any thread starts."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the CUDA tests cover the pinned path")
    with pytest.raises(RuntimeError, match="CUDA"):
        TLoader(_FakeDS(), batch_size=4)
    with pytest.raises(ValueError):
        TLoader(_FakeDS(), batch_size=5, gradient_accumulation_steps=2, device="cpu")


def test_dataset_with_native_transform_equals_jax(dataset_dir, tmp_path):
    """The host CLIP path of both packages inside the dataset: native
    decode + preprocess when it builds (bit-equal), else PIL + each
    package's preprocess (within the CLIP tolerance)."""
    ref = jds.ImgCptDataset(dataset_dir, JTok(24), jtf.get_transforms(64, "clip",
                                                                      input_resolution=32),
                            seq_len=24)
    got = tds.ImgCptDataset(dataset_dir, TTok(24), ttf.get_transforms(64, "clip",
                                                                      input_resolution=32),
                            seq_len=24)
    for i in (0, 3, 5):
        random.seed(i)
        r = ref[i]
        random.seed(i)
        t = got[i]
        np.testing.assert_allclose(t[0], r[0], atol=CLIP_ATOL)
        np.testing.assert_array_equal(t[1], r[1])


def test_batch_loader_raises_what_kills_its_producer():
    """An error that escapes the dataset reaches the consumer's next()
    instead of leaving it waiting on a dead producer."""
    class Broken(_FakeDS):
        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("no loadable sample")
            return super().__getitem__(i)

    loader = TLoader(Broken(12), batch_size=4, num_workers=2, shuffle=False, device="cpu")
    try:
        assert next(loader)[1][0, :, 0].tolist() == [0, 1, 2, 3]
        with pytest.raises(RuntimeError, match="no loadable sample"):
            next(loader)
    finally:
        loader.close()
