"""Offline ARV dataset generation (reference data_generate/, SURVEY §2.8).

Host copy of vqwild_tpu/datagen/pipeline.py: the same inputs give the same
output bytes.

Three steps, run once against the raw ActivityNet v1.3 annotation JSON:

0. ``generate_video_segments`` — cut every annotation into a trimmed segment
   with random background padding up to ``saliency_ratio``× the activity
   length (occupancy-checked on a 10 ms grid), discard segments < 3 s, and
   mine unused 10-180 s stretches as ``distractor_activity`` noise videos
   (0_generate_video_segment.py).
1. ``generate_split_db`` — partition by label sets into the ARV
   training/validation/testing DB with few-shot truncation of novel classes
   and a 10-per-class validation carve-out, tagging ``is_query`` and
   ``retrieval_type`` (1_generate_trainvaltest.py).
2. ``generate_moment_db`` — untrimmed eval DB: gallery = whole ActivityNet
   validation videos with their annotation lists; queries = annotated
   segments > 10 s (2_generate_moment_test.py; emits the v2 schema — the
   shipped v1 files differ slightly: 4,969 vs 4,901 queries on 100_20_80;
   runtime loaders accept both).

Divergences (documented): upstream step 0 draws paddings from the *unseeded*
global RNG — irreproducible by construction; we take an explicit seed.
``generate_label_partitions`` reproduces the upstream partition quirk
(cumulative seed-620 in-place shuffles in package-import order, see
data/labels.py) and is tested against the frozen assets.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

NOISE_LABEL = "distractor_activity"
RESOLUTION = 100  # 10 ms occupancy grid (0_generate_video_segment.py:7)

# partition sizes in upstream package-import order (data_generate/__init__.py)
_PARTITION_IMPORT_ORDER = (
    ("100_20_80", 100),
    ("80_20_100", 80),
    ("120_20_60", 120),
    ("40_20_140", 40),
)


def generate_label_partitions(label_list: Sequence[str]) -> Dict[str, dict]:
    """200 labels (canonical order) → the four effective split partitions."""
    l = list(label_list)
    parts = {}
    for name, ntrain in _PARTITION_IMPORT_ORDER:
        rng = random.Random()
        rng.seed(620)
        rng.shuffle(l)
        parts[name] = dict(
            train=list(l[:ntrain]),
            val=list(l[ntrain : ntrain + 20]),
            test=list(l[ntrain + 20 :]),
        )
    return parts


def generate_video_segments(
    activitynet: dict,
    saliency_ratio: float = 2,
    noise_scan_stride_sec: int = 10,
    noise_length_range_sec=(10, 180),
    activity_minimal_sec: int = 3,
    seed: Optional[int] = None,
) -> List[dict]:
    """activity_net.v1-3.min.json dict → video_segment.json records."""
    rng = random.Random(seed)
    out: List[dict] = []
    for video_id, video in activitynet["database"].items():
        duration = int(video["duration"] * RESOLUTION)
        subset = video["subset"]
        if subset == "testing":
            continue  # no GT for ActivityNet testing
        used = np.zeros(duration, dtype=np.int8)
        segment_list = []
        label_at_mid = {}
        for ann in video["annotations"]:
            s = max(int(ann["segment"][0] * RESOLUTION), 0)
            e = min(int(ann["segment"][1] * RESOLUTION), duration)
            used[s:e] = 1
            segment_list.append((s, e))
            label_at_mid[(s + e) // 2] = ann["label"]

        for s, e in segment_list:
            if s == e or e - s < activity_minimal_sec * RESOLUTION:
                continue
            pad_l = min(s, rng.randint(0, int((e - s) * saliency_ratio)))
            pad_r = min(duration - e - 1, rng.randint(0, int((e - s) * saliency_ratio)))
            # shrink padding until it covers only unused background (≤5 tries)
            for tries in range(6):
                if used[s - pad_l : s].sum() == 0:
                    break
                pad_l //= 2
                if tries >= 4:
                    pad_l = 0
            for tries in range(6):
                if used[e : e + pad_r].sum() == 0:
                    break
                pad_r //= 2
                if tries >= 4:
                    pad_r = 0
            if used[s - pad_l : s].sum() > 0 or used[e : e + pad_r].sum() > 0:
                continue  # area occupied, skip the whole segment
            used[s - pad_l : e + pad_r] = 1
            out.append(
                dict(
                    border=[(s - pad_l) / RESOLUTION, (e + pad_r) / RESOLUTION],
                    segment=[s / RESOLUTION, e / RESOLUTION],
                    label=label_at_mid[(s + e) // 2],
                    video_id=video_id,
                    activitynet_duration=duration / RESOLUTION,
                    activitynet_subset=subset,
                )
            )

        # mine noise videos from unused stretches
        stride = noise_scan_stride_sec * RESOLUTION
        lo, hi = noise_length_range_sec[0] * RESOLUTION, noise_length_range_sec[1] * RESOLUTION
        for i in range(0, duration, stride):
            length = rng.randint(lo, hi)
            if i + length >= duration:
                continue
            if used[i : i + length].sum() == 0:
                used[i : i + length] = 1
                out.append(
                    dict(
                        border=[i / RESOLUTION, (i + length) / RESOLUTION],
                        segment=[i / RESOLUTION, (i + length) / RESOLUTION],
                        label=NOISE_LABEL,
                        video_id=video_id,
                        activitynet_duration=duration / RESOLUTION,
                        activitynet_subset=subset,
                    )
                )
    return out


def generate_split_db(
    segments: Sequence[dict],
    train_labels: Sequence[str],
    val_labels: Sequence[str],
    test_labels: Sequence[str],
    minimal_sample_per_novel_class: int = 5,
    validation_sample_per_class: int = 10,
) -> dict:
    """video_segment records + label partition → arv_db dict
    {training|validation|testing: {label: [record...]}} with is_query /
    retrieval_type tags (1_generate_trainvaltest.py:40-168)."""
    by_subset: Dict[str, Dict[str, List[dict]]] = {"training": {}, "testing": {}}
    for d in segments:
        subset = "training" if d["activitynet_subset"] == "training" else "testing"
        by_subset[subset].setdefault(d["label"], []).append(dict(d))

    tr = by_subset["training"]
    v = validation_sample_per_class
    m = minimal_sample_per_novel_class
    final = {"training": {}, "validation": {}, "testing": by_subset["testing"]}
    for label in train_labels:
        final["training"][label] = tr.get(label, [])[v:]
        final["validation"][label] = tr.get(label, [])[:v]
    for label in list(val_labels) + list(test_labels):
        final["training"][label] = tr.get(label, [])[:m]
    for label in val_labels:
        final["validation"][label] = tr.get(label, [])[m : m + v]
    final["training"][NOISE_LABEL] = tr.get(NOISE_LABEL, [])[v * 20 :]
    final["validation"][NOISE_LABEL] = tr.get(NOISE_LABEL, [])[: v * 20]

    train_set, val_set, test_set = set(train_labels), set(val_labels), set(test_labels)

    def tag(split: str, record: dict):
        label = record["label"]
        if label == NOISE_LABEL:
            record["retrieval_type"] = "noise"
            record["is_query"] = -1 if split == "training" else 0
        elif label in train_set:
            record["retrieval_type"] = "base"
            record["is_query"] = -1 if split == "training" else 1
        elif label in val_set:
            record["retrieval_type"] = "novel"
            if split == "training":
                record["is_query"] = -1
            elif split == "validation":
                record["is_query"] = 1
            else:  # val-novel classes are not queried at test time
                record["is_query"] = 0
        elif label in test_set:
            record["retrieval_type"] = "novel"
            if split == "validation":
                raise ValueError("test-novel label in validation split")
            record["is_query"] = -1 if split == "training" else 1
        else:
            raise ValueError(f"unknown label {label!r}")

    for split, label_dict in final.items():
        for label, records in label_dict.items():
            for r in records:
                tag(split, r)
    return final


def generate_moment_db(
    activitynet: dict,
    train_labels: Sequence[str],
    val_labels: Sequence[str],
    test_labels: Sequence[str],
    min_query_sec: float = 10.0,
) -> dict:
    """activity_net.v1-3.min.json → untrimmed eval DB {query, gallery} (v2).

    Gallery: every ActivityNet-validation video whole, with its annotations.
    Queries: annotated segments > min_query_sec; val-label queries keep no
    retrieval_type (upstream leaves the key unset; they are filtered out by
    possible_classes at eval time).
    """
    train_set, val_set, test_set = set(train_labels), set(val_labels), set(test_labels)
    query, gallery = [], []
    for video_id, video in activitynet["database"].items():
        if video["subset"] != "validation":
            continue
        duration = video["duration"]
        gallery.append(
            dict(
                video_id=video_id,
                segment=[0, duration],
                border=[0, duration],
                activitynet_duration=duration,
                activitynet_subset="validation",
                annotations=video["annotations"],
            )
        )
        for ann in video["annotations"]:
            seg = ann["segment"]
            if seg[1] - seg[0] <= min_query_sec:
                continue
            q = dict(
                video_id=video_id,
                label=ann["label"],
                segment=seg,
                border=seg,
                activitynet_duration=duration,
                activitynet_subset="validation",
            )
            if ann["label"] in test_set:
                q["retrieval_type"] = "novel"
            elif ann["label"] in train_set:
                q["retrieval_type"] = "base"
            else:
                assert ann["label"] in val_set, ann["label"]
            query.append(q)
    return dict(query=query, gallery=gallery)


def write_json(obj, path: str):
    with open(path, "w") as f:
        json.dump(obj, f)
