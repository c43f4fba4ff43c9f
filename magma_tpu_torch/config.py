"""Config system: YAML -> MultimodalConfig dataclass.

A copy of ``magma_tpu/config.py`` (that package's ``__init__`` imports
jax, so the port cannot import it).  Mirrors the reference surface
(magma/config.py:20-144) so existing MAGMA YAML configs
(configs/MAGMA_v1.yml, MAGMA_v2.yml) load unchanged; the JAX package's
extra fields (mesh shape, precision policy, attention_impl) are kept so
one YAML drives both packages.
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, asdict
from pathlib import Path
from typing import Any, Optional, Union

import yaml


def load_config(path: Union[str, Path], config_dir: Path = Path("configs")) -> dict:
    """Load a YAML config file, trying `config_dir` if the bare path misses.

    Parity: reference magma/config.py:10-17.
    """
    path = str(path)
    if not path.endswith(".yml") and not path.endswith(".yaml"):
        path += ".yml"
    if not os.path.exists(path):
        path = str(config_dir / path)
    with open(path, "r") as stream:
        return yaml.safe_load(stream)


@dataclass
class MultimodalConfig:
    """Training / model / data configuration.

    Field names and defaults match the reference dataclass
    (magma/config.py:20-98) so published YAMLs parse directly.  TPU-specific
    fields are grouped at the bottom and all have defaults, so reference
    configs need no edits.
    """

    # Training
    # ------------------------------------------------------------
    batch_size: int
    train_steps: int
    optimizer_name: str = "AdamW"
    lr: float = 8.0e-4
    image_enc_lr: Optional[float] = None
    min_lr: float = 0.0
    lr_decay_iters: Optional[int] = None
    gradient_accumulation_steps: int = 1
    image_size: int = 256
    eval_every: int = 250
    eval_steps: int = 25
    zero_stage: int = 2  # accepted for YAML parity; optimizer sharding is
    # expressed through mesh/sharding rules instead (see parallel/sharding.py)
    gradient_clipping: float = 1.0
    warmup_num_steps: int = 100
    weight_decay: float = 0.00
    run_blind: bool = False
    fine_tune: bool = False
    load_optimizer: bool = True

    # Checkpointing
    # ------------------------------------------------------------
    save_every: int = 2500
    save: Optional[str] = None
    load: Optional[str] = None

    # Data
    # ------------------------------------------------------------
    train_dataset_name: str = "conceptual_captions"
    eval_dataset_name: str = "/data/conceptual_captions"
    train_dataset_dir: Any = "/data/coco_data"
    eval_dataset_dir: Any = "/data/coco_data"
    eval_dataset_pct: float = 0.1
    dataset_type: Optional[str] = None  # accepted for MAGMA_v2.yml parity
    vqa_dir: Optional[str] = None
    gqa_dir: Optional[str] = None

    # Model architecture
    # ------------------------------------------------------------
    encoder_name: str = "clip"
    tokenizer_name: str = "gpt2"
    lm_name: str = "EleutherAI/gpt-j-6B"
    image_seq_len: int = 2
    pretrained_img_encoder: bool = False
    seq_len: Optional[int] = None

    # Layer freezing
    # ------------------------------------------------------------
    freeze_lm: bool = True
    freeze_img_encoder: bool = True

    image_embed_dropout_prob: float = 0.0
    use_image_embed_layernorm: bool = False

    # Adapter settings
    # ------------------------------------------------------------
    adapter_config: Optional[dict] = None

    # Classification finetuning
    # ------------------------------------------------------------
    class_dict: Optional[dict] = None

    # Logging
    # ------------------------------------------------------------
    name: Optional[str] = None
    log_every: int = 1
    wandb_project: str = "magma"

    # ------------------------------------------------------------
    # TPU-native fields (no reference equivalent; replace the DeepSpeed
    # config dict synthesized at magma/config.py:124-134)
    # ------------------------------------------------------------
    # Refuse the byte-fallback tokenizer (raise instead of warn) — set in
    # production so garbage text can never ship with perfect shapes; the
    # reference always runs real GPT-2 BPE (magma/utils.py:43-58).
    strict_tokenizer: bool = False
    # Mesh: data-parallel x tensor-parallel axis sizes.  -1 on dp means
    # "all remaining devices".
    mesh_dp: int = -1
    mesh_tp: int = 1
    # Sequence-parallel axis size (ring attention over "sp"); > 1 adds an
    # "sp" mesh axis and requires attention_impl="ring".
    mesh_sp: int = 1
    # Compute/parameter precision.  bf16 is TPU-native and replaces the
    # reference's fp16 + dynamic loss scaling (magma/config.py:128).
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"  # trainable params; frozen LM stored in bf16
    frozen_dtype: str = "bfloat16"
    # Attention implementation: "flash" (Pallas kernel), "xla" (reference
    # einsum), or "ring" (context-parallel over the mesh "sp" axis —
    # shards the training sequence across chips, parallel/ring_attention).
    attention_impl: str = "flash"
    # Remat (gradient checkpointing) for LM blocks; replaces
    # language_model.py:23 gradient_checkpointing.
    remat: bool = True
    # QLoRA-style training: store the frozen LM as int8 (halves its HBM
    # footprint; gradients flow through dedicated Pallas kernels; weight
    # cotangents are structurally zero).  Enables full-scale adapter
    # finetuning on a single 16 GB chip.
    train_lm_int8: bool = False
    # LM size override for tests/small runs: dict(n_layers=..., d_model=...).
    lm_overrides: Optional[dict] = None
    # Vision tower overrides for tests (e.g. dict(width=8, layers=(1,1,1,1))).
    encoder_overrides: Optional[dict] = None
    # Data loading workers (host-side).
    num_workers: int = 8
    # Seed
    seed: int = 0

    def print(self) -> None:
        from magma_tpu_torch.utils import is_main

        if is_main():
            from pprint import pprint

            print("-" * 100)
            pprint(self.__dict__, indent=4)
            print("-" * 100)

    def __post_init__(self) -> None:
        self.is_classifier = self.class_dict is not None
        if self.adapter_config is None:
            self.adapter_config = {}

        # LR schedule selection mirrors the reference's WarmupLR vs
        # WarmupDecayLR choice (magma/config.py:101-123): a warmup-then-
        # constant schedule when lr_decay_iters is unset, else warmup-then-
        # linear-decay over lr_decay_iters steps.
        self.lr_scheduler = "WarmupLR" if self.lr_decay_iters is None else "WarmupDecayLR"

        if self.name is None:
            self.name = str(uuid.uuid4())[:8]

    @classmethod
    def from_yml(cls, path: Union[str, Path]) -> "MultimodalConfig":
        raw = load_config(path)
        known = {f.name for f in cls.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        unknown = {k: v for k, v in raw.items() if k not in known}
        if unknown:
            # Tolerate unknown keys the way the reference tolerates extra
            # state-dict keys (strict=False): warn, don't crash.
            print(f"[magma_tpu_torch] ignoring unknown config keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in raw.items() if k in known})

    def to_dict(self) -> dict:
        d = asdict(self)
        d["is_classifier"] = self.is_classifier
        d["lr_scheduler"] = self.lr_scheduler
        return d
