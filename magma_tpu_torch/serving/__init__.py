"""Continuous-batching serving over size-classed KV cache pools."""

from magma_tpu_torch.serving.engine import FinishedRequest, LMServingEngine, MagmaServingEngine

__all__ = ["FinishedRequest", "LMServingEngine", "MagmaServingEngine"]
