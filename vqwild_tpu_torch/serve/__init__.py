"""Serving layer: gallery index on the device + micro-batched query service."""

from vqwild_tpu_torch.serve.index import GalleryIndex
from vqwild_tpu_torch.serve.service import QueryService

__all__ = ["GalleryIndex", "QueryService"]
