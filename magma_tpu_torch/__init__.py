"""magma_tpu_torch -- the PyTorch/CUDA port of magma_tpu, for one NVIDIA H100.

The JAX package ``magma_tpu`` stays the reference; this package mirrors its
module layout and function names, imports torch (never jax), and replaces
each Pallas kernel on its path with a hand-written Hopper kernel
(``csrc/``).  It covers the caption path: ``Magma.from_checkpoint`` ->
``preprocess_inputs`` -> ``embed`` -> ``generate`` (split into chunked
prefill and decode windows above 8192 positions), at bf16 with prefill
attention as a CUDA kernel, and after ``Magma.quantize_for_serving(bits=8
or 4)`` with the quantized products and the whole-layer decode as CUDA
kernels too; continuous batching over size-classed KV cache pools
(``LMServingEngine``, ``MagmaServingEngine``); and adapter training
(``magma_tpu_torch.training.train_loop.Trainer``), bf16 or over the int8
QLoRA layout, with the flash-attention backward and the int8 input
gradient as CUDA kernels, fed from images on disk by the dataset, the
threaded loader and the CLI (``python -m magma_tpu_torch.train --config
...``), with evaluation (eval loss, captions, VQA) and classification
fine-tuning (``MagmaClassifier``).  Every image tower of the JAX package
is ported: the CLIP ResNets, the CLIP ViT-B/32 (the default) and
NF-ResNet50.  Parallelism runs over ``torch.distributed`` (``make_mesh``),
checkpoints restore from a directory (``Magma.from_checkpoint``), and
``python -m magma_tpu_torch.convert`` converts a reference checkpoint.
"""

from magma_tpu_torch.config import MultimodalConfig, load_config
from magma_tpu_torch.tokenizer import get_tokenizer
from magma_tpu_torch.utils import count_parameters, cycle, is_main, print_main

__version__ = "0.1.0"

_LAZY = {
    "Magma": ("magma_tpu_torch.models.magma", "Magma"),
    "MagmaClassifier": ("magma_tpu_torch.models.classifier", "MagmaClassifier"),
    "Trainer": ("magma_tpu_torch.training.train_loop", "Trainer"),
    "ImageInput": ("magma_tpu_torch.data.image_input", "ImageInput"),
    "ImgCptDataset": ("magma_tpu_torch.data.dataset", "ImgCptDataset"),
    "collate_fn": ("magma_tpu_torch.data.dataset", "collate_fn"),
    "convert_dataset": ("magma_tpu_torch.data.convert", "convert_dataset"),
    "BatchLoader": ("magma_tpu_torch.data.loader", "BatchLoader"),
    "make_mesh": ("magma_tpu_torch.parallel.mesh", "make_mesh"),
    "get_transforms": ("magma_tpu_torch.data.transforms", "get_transforms"),
    "load_pretrained_encoder": ("magma_tpu_torch.convert", "load_pretrained_encoder"),
    "LMServingEngine": ("magma_tpu_torch.serving", "LMServingEngine"),
    "MagmaServingEngine": ("magma_tpu_torch.serving", "MagmaServingEngine"),
}


def __getattr__(name):
    # lazy: `import magma_tpu_torch` stays light and cycle-free
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'magma_tpu_torch' has no attribute {name!r}")


__all__ = ["MultimodalConfig", "load_config", "get_tokenizer", "Magma", "MagmaClassifier",
           "Trainer", "ImageInput", "ImgCptDataset", "collate_fn", "convert_dataset",
           "BatchLoader", "make_mesh", "get_transforms", "load_pretrained_encoder",
           "LMServingEngine", "MagmaServingEngine", "count_parameters", "is_main",
           "print_main", "cycle"]
