from magma_tpu_torch.data.convert import convert_dataset
from magma_tpu_torch.data.dataset import ImgCptDataset, collate_fn
from magma_tpu_torch.data.image_input import ImageInput

__all__ = ["ImgCptDataset", "collate_fn", "convert_dataset", "ImageInput"]
