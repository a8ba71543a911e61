from vqwild_tpu_torch.datagen.pipeline import (
    generate_label_partitions,
    generate_moment_db,
    generate_split_db,
    generate_video_segments,
)

__all__ = [
    "generate_label_partitions",
    "generate_moment_db",
    "generate_split_db",
    "generate_video_segments",
]
