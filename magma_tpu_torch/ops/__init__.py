from magma_tpu_torch.ops.rotary import rotary_sincos, apply_rotary
from magma_tpu_torch.ops.attention import causal_attention, decode_attention

__all__ = ["rotary_sincos", "apply_rotary", "causal_attention", "decode_attention"]
