from vqwild_tpu_torch.retrieval.features import make_feat_fn
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer

__all__ = ["GalleryScorer", "make_feat_fn"]
