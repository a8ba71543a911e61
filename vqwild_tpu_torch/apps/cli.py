"""Shared set-up for the entry points: locating the dataset files and
building the data half of the stack.

Counterpart of vqwild_tpu/apps/cli.py ``resolve_data_file`` and the data
half of ``build_stack`` (split, DB, frame store). The command line itself
(training, --evaluate, export) is not ported yet.
"""

from __future__ import annotations

import os

from vqwild_tpu_torch.core.config import ExperimentConfig
from vqwild_tpu_torch.data.frames import make_frame_store
from vqwild_tpu_torch.data.labels import get_split
from vqwild_tpu_torch.data.schema import load_trimmed_db

# candidate roots, under the data root, for the ARV db / word-embedding
# artifacts
_DATA_SEARCH_PATHS = ("", "data", "data_generate", "word_embed")


def resolve_data_file(name: str, data_root: str) -> str:
    if os.path.isabs(name) and os.path.exists(name):
        return name
    for root in _DATA_SEARCH_PATHS:
        cand = os.path.join(data_root, root, name) if root else os.path.join(data_root, name)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"{name} not found under {data_root} or known data locations"
    )


def build_data_stack(cfg: ExperimentConfig):
    """(split spec, trimmed DB, frame store) for ``cfg.data``."""
    spec = get_split(cfg.data.meta_split)
    db = load_trimmed_db(resolve_data_file(spec.db_json, cfg.data.data_root))
    store = make_frame_store(cfg.data.frame_store, cfg.data.frames_dir)
    return spec, db, store
