from vqwild_tpu_torch.data.labels import (
    ACTIVITYNET_LABELS,
    NOISE_LABEL,
    SplitSpec,
    split_registry,
)
from vqwild_tpu_torch.data.schema import (
    MomentDB,
    TrimmedDB,
    VideoRecord,
    load_moment_db,
    load_trimmed_db,
    load_word_embeddings,
)
from vqwild_tpu_torch.data.sampling import sample_frame_indices, segment_to_frames

__all__ = [
    "ACTIVITYNET_LABELS",
    "NOISE_LABEL",
    "SplitSpec",
    "split_registry",
    "MomentDB",
    "TrimmedDB",
    "VideoRecord",
    "load_moment_db",
    "load_trimmed_db",
    "load_word_embeddings",
    "sample_frame_indices",
    "segment_to_frames",
]
