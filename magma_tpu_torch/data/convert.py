"""Dataset converter: a user's iterator -> the MAGMA on-disk layout.

Port of ``magma_tpu/data/convert.py`` (reference
magma/datasets/convert_datasets.py:33-118), one streaming pass over two
shard allocators:

* the iterator yields ``(img_path, {"captions": [...], "metadata": {...}})``,
* each *unique* source image is moved or copied into ``images/{shard}/``,
* each sample gets one json at ``image_data/{shard}/{sample_idx}.json``
  whose ``image_path`` points at the relocated image,
* both trees hold at most ``dir_size`` entries a shard (image shards count
  unique images, data shards count samples, so the two counters advance
  independently when duplicates occur),
* an optional ``hash_fn`` (e.g. a perceptual hash) records a dedup hash in
  each sample's metadata; a repeated source path reuses the stored image
  and its hash instead of copying twice.

Each sample is written as it arrives: constant memory on any size.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Callable, Iterable, Optional


class _ShardAllocator:
    """Hands out ``{root}/{shard}/`` directories, at most ``per_shard``
    allocations per shard, creating directories on first use."""

    def __init__(self, root: Path, per_shard: int):
        self._root = Path(root)
        self._per_shard = per_shard
        self._allocated = 0

    def allocate(self) -> Path:
        shard_dir = self._root / str(self._allocated // self._per_shard)
        shard_dir.mkdir(parents=True, exist_ok=True)
        self._allocated += 1
        return shard_dir


def _hash_image(img_path, hash_fn: Callable) -> Optional[str]:
    try:
        from PIL import Image

        with Image.open(img_path) as img:
            return str(hash_fn(img.convert("RGB")))
    except Exception:
        print("Warning: corrupted or non-existent Image")
        return None


def convert_dataset(
    data_dir,
    dir_size: int = 10000,
    hash_fn: Optional[Callable] = None,
    mode: str = "mv",
    ds_iterator: Optional[Iterable] = None,
) -> None:
    """Build a dataset directory in the standard format (see module doc).

    ``mode="mv"`` moves source images (the reference's default, for
    converting in place); ``mode="cp"`` copies and leaves sources intact.
    """
    root = Path(data_dir)
    image_shards = _ShardAllocator(root / "images", dir_size)
    record_shards = _ShardAllocator(root / "image_data", dir_size)
    relocate = shutil.move if mode == "mv" else shutil.copy

    # source path -> {"image_path": relative stored path, "hash": optional}
    # (or None: relocation failed — skip every sample of that image)
    seen: dict = {}
    n_skipped = 0

    for sample_idx, (img_path, sample) in enumerate(ds_iterator or ()):
        key = str(img_path)
        if key not in seen:
            entry = {}
            if hash_fn is not None:
                h = _hash_image(img_path, hash_fn)
                if h is not None:
                    entry["hash"] = h
            if not Path(img_path).is_file():
                # common failure caught before burning a shard slot
                print(f"Warning: missing image {img_path}; skipping its "
                      "samples")
                seen[key] = None
                n_skipped += 1
                continue
            shard_dir = image_shards.allocate()
            try:
                relocate(str(img_path), str(shard_dir))
                entry["image_path"] = (
                    f"images/{shard_dir.name}/{Path(img_path).name}"
                )
            except OSError as e:
                # do NOT write a record pointing at a file that was never
                # stored — that poisons every epoch with the corrupt-image
                # fallback; drop the sample (and its duplicates) instead
                print(f"Warning: could not store image {img_path}: {e}; "
                      "skipping its samples")
                entry = None
            seen[key] = entry
        entry = seen[key]
        if entry is None:
            n_skipped += 1
            continue

        record = dict(sample)
        record["image_path"] = entry["image_path"]
        if "hash" in entry:
            record.setdefault("metadata", {})["image_hash"] = entry["hash"]

        record_dir = record_shards.allocate()
        with open(record_dir / f"{sample_idx}.json", "w") as f:
            json.dump(record, f)

    if n_skipped:
        print(f"Warning: skipped {n_skipped} samples whose images could "
              "not be stored")
