"""magma_tpu_torch -- the PyTorch/CUDA port of magma_tpu, for one NVIDIA H100.

The JAX package ``magma_tpu`` stays the reference; this package mirrors its
module layout and function names, imports torch (never jax), and replaces
each Pallas kernel on its path with a hand-written Hopper kernel
(``csrc/``).  It covers the single-image caption path:
``Magma.from_checkpoint`` -> ``preprocess_inputs`` -> ``embed`` ->
``generate``, at bf16 with prefill attention as a CUDA kernel, and after
``Magma.quantize_for_serving(bits=8)`` with the int8 products as CUDA
kernels too.
"""

from magma_tpu_torch.config import MultimodalConfig, load_config
from magma_tpu_torch.tokenizer import get_tokenizer
from magma_tpu_torch.utils import is_main

__version__ = "0.1.0"

_LAZY = {
    "Magma": ("magma_tpu_torch.models.magma", "Magma"),
    "ImageInput": ("magma_tpu_torch.data.image_input", "ImageInput"),
    "get_transforms": ("magma_tpu_torch.data.transforms", "get_transforms"),
}


def __getattr__(name):
    # lazy: `import magma_tpu_torch` stays light and cycle-free
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'magma_tpu_torch' has no attribute {name!r}")


__all__ = ["MultimodalConfig", "load_config", "get_tokenizer", "Magma", "ImageInput",
           "get_transforms", "is_main"]
