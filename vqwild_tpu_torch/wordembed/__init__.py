from vqwild_tpu_torch.wordembed.build import build_class_embeddings, load_vector_table
from vqwild_tpu_torch.wordembed.check import nearest_neighbor_report

__all__ = ["build_class_embeddings", "load_vector_table", "nearest_neighbor_report"]
