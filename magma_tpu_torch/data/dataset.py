"""Image-caption dataset over the MAGMA on-disk layout.

Port of ``magma_tpu/data/dataset.py`` (reference
magma/datasets/dataset.py:92-160) over the layout:

    {data_dir}/images/{n}/xxx.jpg
    {data_dir}/image_data/{n}/{idx}.json   -- {"image_path": ...,
                                              "captions": [...],
                                              "metadata": {...}}

* lazy per-item json loading; an unreadable json falls back to a random
  other index (dataset.py:78-89),
* a record without "image_path" resolves to the sibling image named after
  the json file's stem (dataset.py:119-132),
* one caption is drawn at random per access (dataset.py:135), tokenized
  and padded to seq_len with EOS (dataset.py:136-142),
* a corrupt or unreadable image falls back to a random other index
  (dataset.py:144-152), in a bounded retry loop.

Samples are host numpy arrays: (1, 3, H, W) float32 pixels and (1, seq)
int32 tokens; ``data/loader.py`` batches them for the card.  The random
draws come from Python's ``random`` and numpy's ``RandomState``, as in the
JAX package, so the same seeds give the same samples.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_MAX_RETRIES = 32

try:  # bad-data exception set for the __getitem__ retry loop
    from PIL import Image as _PILImage

    _DATA_ERRORS: tuple = (OSError, IndexError, KeyError, ValueError,
                           _PILImage.DecompressionBombError)
except Exception:  # PIL-less environments
    _DATA_ERRORS = (OSError, IndexError, KeyError, ValueError)


def load_json(filename) -> Optional[dict]:
    """Read one record json; None (with a log line) if undecodable or
    not a dict record."""
    try:
        record = json.loads(Path(filename).read_text())
    except Exception as e:
        print(f"skipping unreadable record {filename}: {e!r}")
        return None
    if not isinstance(record, dict):
        print(f"skipping non-record json {filename}")
        return None
    return record


class LazyLoader:
    """Per-item json access over the image_data tree.  A bad file yields a
    random healthy record instead of raising."""

    def __init__(self, data_dir):
        self.paths: List[Path] = sorted(
            (Path(data_dir) / "image_data").glob("*/*.json")
        )

    def __len__(self) -> int:
        return len(self.paths)

    def get_with_path(self, idx) -> Tuple[dict, Path]:
        """Record plus ITS OWN json path: the internal redraw on a bad
        file must move both together, or the sibling-jpg fallback pairs a
        redrawn record with the broken file's path."""
        for _ in range(_MAX_RETRIES):
            record = load_json(self.paths[idx])
            if record is not None:
                return record, self.paths[idx]
            idx = random.randrange(len(self))
        raise RuntimeError(f"no readable record after {_MAX_RETRIES} draws")

    def __getitem__(self, idx) -> dict:
        return self.get_with_path(idx)[0]


class ImgCptDataset:
    """Map-style dataset -> (image (1,3,H,W) float32, caption (1,seq) int32)."""

    def __init__(
        self,
        data_dir,
        tokenizer,
        transforms,
        seq_len: int = 2048,
        load_data_in_memory: bool = False,
    ):
        self.data_dir = Path(data_dir)
        self.tokenizer = tokenizer
        self.transforms = transforms
        self.seq_len = seq_len
        self.load_data_in_memory = load_data_in_memory
        self._lazy = LazyLoader(self.data_dir)
        if load_data_in_memory:
            # filter records and paths TOGETHER: _image_file pairs
            # self.data[idx] with self._paths[idx] for the sibling-jpg
            # fallback, so the two lists must stay aligned
            loaded = [
                (r, p)
                for r, p in ((load_json(p), p) for p in self._lazy.paths)
                if r is not None
            ]
            self.data: Sequence = [r for r, _ in loaded]
            self._paths = [p for _, p in loaded]
        else:
            self.data = self._lazy
            self._paths = self._lazy.paths

    def __len__(self) -> int:
        return len(self.data)

    def _image_file(self, record: dict, json_path: Path) -> Path:
        """Stored path from the record, else the sibling jpg sharing the
        json's stem (reference dataset.py:119-132)."""
        rel = record.get("image_path")
        if rel is not None:
            return self.data_dir / rel
        shard = json_path.parent.name
        return self.data_dir / "images" / shard / (json_path.stem + ".jpg")

    def _load_one(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.load_data_in_memory:
            record, json_path = self.data[idx], self._paths[idx]
        else:  # lazy: the loader redraws record AND path together
            record, json_path = self._lazy.get_with_path(idx)
        if getattr(self.transforms, "wants_path", False):
            # native C++ path: decode + preprocess in one GIL-free call
            # (magma_tpu_torch/native); raises IOError -> retry loop below
            pixels = self.transforms(self._image_file(record, json_path))
        else:
            from PIL import Image

            with Image.open(self._image_file(record, json_path)) as img:
                pixels = self.transforms(img)
        caption = random.choice(record["captions"])
        tokens = self.tokenizer.encode(
            caption, max_length=self.seq_len, padding="max_length",
            truncation=True,
        )
        return np.asarray(pixels, np.float32), tokens

    def __getitem__(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        for _ in range(_MAX_RETRIES):
            try:
                return self._load_one(idx)
            except _DATA_ERRORS as e:
                # unreadable/corrupt sample (incl. PIL and native-loader
                # IOErrors, truncated files, decompression bombs): draw
                # another.  Programming errors (TypeError etc.) propagate
                # instead of being masked as bad data.
                print(f"sample {idx} unreadable ({e!r}); drawing another")
                idx = random.randrange(len(self))
        raise RuntimeError(f"no loadable sample after {_MAX_RETRIES} draws")


def collate_fn(
    batch_data: Sequence[Tuple[np.ndarray, np.ndarray]], seq_len: int = 2048
) -> Tuple[np.ndarray, np.ndarray]:
    """[(img, cpt), ...] -> (images (b,3,H,W), captions (b,seq)).
    Parity: dataset.py:155-160."""
    all_images, all_captions = zip(*batch_data)
    return (
        np.concatenate(all_images, axis=0),
        np.concatenate([c[:, :seq_len] for c in all_captions], axis=0),
    )


class ConcatDataset:
    """Concatenation of datasets (replaces torch.utils.data.ConcatDataset
    used at train.py:36-38)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[ds][idx - int(self._offsets[ds])]


class SubsetDataset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]


def random_split(dataset, lengths: Sequence[int], seed: int = 0):
    """Deterministic random split (replaces torch random_split at
    train.py:62)."""
    assert sum(lengths) == len(dataset)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(dataset))
    out, start = [], 0
    for n in lengths:
        out.append(SubsetDataset(dataset, perm[start : start + n]))
        start += n
    return out
