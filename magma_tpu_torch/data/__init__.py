from magma_tpu_torch.data.image_input import ImageInput

__all__ = ["ImageInput"]
