"""Seeded multi-query expansion (generate_multi_query,
dataloader_baseline.py:296-322).

Each query is expanded to [query] + 4 same-class extras drawn with
``random.choices`` after a fixed ``random.seed(620)`` — stdlib Mersenne
Twister, reproduced with the stdlib so expansion lists match upstream
byte-for-byte for identical query lists. At ranking time the first
``query_num`` feature vectors are averaged and *all* expanded video_ids are
excluded from the gallery.
"""

from __future__ import annotations

import random
from typing import Callable, List, Sequence, TypeVar

T = TypeVar("T")


def generate_multi_query(
    query_list: Sequence[T],
    label_of: Callable[[T], str],
    video_id_of: Callable[[T], str],
    extras: int = 4,
    seed: int = 620,
) -> List[List[T]]:
    rng = random.Random()
    rng.seed(seed)
    cls_dict = {}
    for q in query_list:
        cls_dict.setdefault(label_of(q), []).append(q)

    expanded: List[List[T]] = []
    for q in query_list:
        same = [o for o in cls_dict[label_of(q)] if video_id_of(o) != video_id_of(q)]
        # upstream would crash on a singleton query class (random.choices on an
        # empty list); degrade to no extras instead (documented divergence —
        # only reachable on truncated/debug query sets)
        extra = rng.choices(same, k=extras) if same else []
        expanded.append([q] + extra)
    return expanded
