"""Device ops: preprocess, and the two kernels (K1 in distance.py, K2 in
stem_pool.py) with their plain PyTorch versions."""

from vqwild_tpu_torch.ops.distance import pairwise_sq_l2, score_matrix, sq_l2
from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool, stem_s2d_pool_plain

__all__ = ["pairwise_sq_l2", "score_matrix", "sq_l2", "stem_s2d_pool", "stem_s2d_pool_plain"]
