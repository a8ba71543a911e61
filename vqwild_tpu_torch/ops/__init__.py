"""Device ops: preprocess, window pooling, and the two kernels (K1 in
distance.py, K2 in stem_pool.py) with their plain PyTorch versions."""

from vqwild_tpu_torch.ops.distance import pairwise_sq_l2, score_matrix, sq_l2
from vqwild_tpu_torch.ops.segment_pool import sliding_window_mean, window_mean_from_cumsum
from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool, stem_s2d_pool_plain

__all__ = ["pairwise_sq_l2", "score_matrix", "sq_l2", "sliding_window_mean",
           "stem_s2d_pool", "stem_s2d_pool_plain", "window_mean_from_cumsum"]
