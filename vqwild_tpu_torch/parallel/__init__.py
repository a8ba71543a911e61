from vqwild_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    pad_to_multiple,
    rank_rows,
    shard_batch_arrays,
)

__all__ = ["Mesh", "make_mesh", "pad_to_multiple", "rank_rows", "shard_batch_arrays"]
