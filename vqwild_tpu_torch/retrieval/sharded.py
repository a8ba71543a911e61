"""Device-resident gallery scoring.

Counterpart of vqwild_tpu/retrieval/sharded.py ``GalleryScorer`` on one
device (the mesh-sharded gallery comes with the multi-GPU slice).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from vqwild_tpu_torch.core.device import resolve_device
from vqwild_tpu_torch.ops.distance import score_matrix


class GalleryScorer:
    """Holds the gallery on the device; scores query chunks with kernel K1."""

    def __init__(self, gallery_feats: np.ndarray, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        g = np.array(gallery_feats, np.float32, order="C")  # a copy: feats may be a read-only memmap
        self.n = g.shape[0]
        self.n_padded = self.n  # one device: no shard padding
        self.g_dev = torch.from_numpy(g).to(self.device)

    def scores(self, qfeats) -> torch.Tensor:
        """[B, D] queries → [B, n_padded] scores −‖q−g‖² (device tensor)."""
        q = torch.as_tensor(qfeats, dtype=torch.float32).to(self.device).contiguous()
        return score_matrix(q, self.g_dev)
