"""ImageInput: wraps a local path or URL into a PIL image.

A copy of ``magma_tpu/data/image_input.py`` (reference
magma/image_input.py:6-24).
"""

from __future__ import annotations

from io import BytesIO
from typing import Callable


class ImageInput:
    """Image prompt element accepted by ``Magma.preprocess_inputs``.

    Args:
        path_or_url: local file path or http(s) URL.
    """

    def __init__(self, path_or_url: str):
        import PIL.Image as PilImage

        self.path_or_url = path_or_url
        if path_or_url.startswith(("http://", "https://")):
            try:
                import requests

                response = requests.get(path_or_url, timeout=30)
                response.raise_for_status()
                self.pil_image = PilImage.open(BytesIO(response.content))
            except Exception as e:
                raise Exception(
                    f"Could not retrieve image from url:\n{path_or_url}"
                ) from e
        else:
            self.pil_image = PilImage.open(path_or_url)

    def get_transformed_image(self, transform_fn: Callable):
        """Apply a transform pipeline; returns whatever the pipeline emits
        (here: a (1, 3, H, W) tensor)."""
        return transform_fn(self.pil_image)
