from vqwild_tpu_torch.retrieval.aggregate import MetricAggregator
from vqwild_tpu_torch.retrieval.clip import ARVRetrievalClip
from vqwild_tpu_torch.retrieval.features import FeatureExtractor, make_fake_feat_fn, make_feat_fn
from vqwild_tpu_torch.retrieval.moment import ARVRetrievalMoment
from vqwild_tpu_torch.retrieval.multiquery import generate_multi_query
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer
from vqwild_tpu_torch.retrieval.trimmed import ARVRetrievalTrimmed

__all__ = [
    "MetricAggregator",
    "ARVRetrievalClip",
    "ARVRetrievalMoment",
    "ARVRetrievalTrimmed",
    "FeatureExtractor",
    "GalleryScorer",
    "make_feat_fn",
    "make_fake_feat_fn",
    "generate_multi_query",
]
