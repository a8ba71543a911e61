"""Parsers for the ARV dataset JSON formats shipped by the reference.

Three schemas (produced by the reference's offline pipeline, consumed at
runtime):

* trimmed DB ``arv_db_{split}.json``:
    {"training"|"validation"|"testing": {label: [record, ...]}}
  record keys: segment, border, activitynet_subset, label,
  activitynet_duration, video_id, is_query (-1/0/1), retrieval_type
  (base/novel/noise).   (1_generate_trainvaltest.py:97-168)

* untrimmed/moment DB ``arv_db_{split}_untrimmed.json`` (v1 — the format the
  runtime actually reads, see activitynet_label_100_20_80.py:12-14):
    {"query": [record...], "gallery": [record...]}
  gallery records additionally carry an ``annotations`` list of
  {segment, label}.   (2_generate_moment_test.py:19-54)

* word embeddings ``wordembed_{model}_d{dim}.json``: {label: [float...]}
  L2-normalized per row on load (dataloader_baseline.py:142-166).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from vqwild_tpu_torch.data.labels import NOISE_LABEL, SplitSpec


@dataclasses.dataclass
class Annotation:
    segment: Tuple[float, float]
    label: str


@dataclasses.dataclass
class VideoRecord:
    """One (possibly trimmed) video segment."""

    video_id: str
    label: str
    segment: Tuple[float, float]  # seconds inside the source video
    border: Tuple[float, float]
    activitynet_subset: str  # "training" | "validation"
    activitynet_duration: float
    is_query: int = 0  # -1/0/1 (trimmed DB only)
    retrieval_type: str = ""  # base | novel | noise
    annotations: Optional[List[Annotation]] = None  # untrimmed gallery only

    @classmethod
    def from_json(cls, d: dict) -> "VideoRecord":
        anns = None
        if "annotations" in d:
            anns = [
                Annotation(segment=(a["segment"][0], a["segment"][1]), label=a["label"])
                for a in d["annotations"]
            ]
        return cls(
            video_id=d["video_id"],
            label=d.get("label", ""),
            segment=(d["segment"][0], d["segment"][1]),
            border=(d.get("border", d["segment"])[0], d.get("border", d["segment"])[1]),
            activitynet_subset=d["activitynet_subset"],
            activitynet_duration=float(d["activitynet_duration"]),
            is_query=int(d.get("is_query", 0)),
            retrieval_type=d.get("retrieval_type", ""),
            annotations=anns,
        )

    @property
    def duration_sec(self) -> float:
        return self.segment[1] - self.segment[0]


@dataclasses.dataclass
class TrimmedDB:
    """Parsed trimmed DB: split name → {label: [VideoRecord]}."""

    splits: Dict[str, Dict[str, List[VideoRecord]]]

    def flat(self, split: str) -> List[VideoRecord]:
        """All records of a split, label-dict iteration order preserved
        (matches ARV_Retrieval.load_data, dataloader_baseline.py:1437-1445)."""
        out: List[VideoRecord] = []
        for recs in self.splits[split].values():
            out.extend(recs)
        return out

    def training_for_fewshot(
        self, spec: SplitSpec, novel_num: int
    ) -> Dict[str, List[VideoRecord]]:
        """Training dict with noise dropped and novel classes truncated to
        ``novel_num`` samples (dataloader_baseline.py:119-140)."""
        out: Dict[str, List[VideoRecord]] = {}
        train_set = set(spec.train_labels)
        for label, recs in self.splits["training"].items():
            if label == NOISE_LABEL:
                continue
            out[label] = list(recs) if label in train_set else list(recs[:novel_num])
        return out

    def cls2int(self, spec: SplitSpec, novel_num: int) -> Dict[str, int]:
        """Label → class index in training-dict insertion order
        (dataloader_baseline.py:140: asserts exactly nclass labels)."""
        return {
            label: i
            for i, label in enumerate(self.training_for_fewshot(spec, novel_num))
        }


@dataclasses.dataclass
class MomentDB:
    query: List[VideoRecord]
    gallery: List[VideoRecord]

    def nonnoise_queries(self) -> List[VideoRecord]:
        # dataloader_baseline.py:684-687 / :988-991
        return [q for q in self.query if q.retrieval_type != "noise"]


def load_trimmed_db(path: str) -> TrimmedDB:
    with open(path) as f:
        raw = json.load(f)
    splits = {}
    for split, label_dict in raw.items():
        splits[split] = {
            label: [VideoRecord.from_json(r) for r in recs]
            for label, recs in label_dict.items()
        }
    return TrimmedDB(splits=splits)


def load_moment_db(path: str) -> MomentDB:
    with open(path) as f:
        raw = json.load(f)
    return MomentDB(
        query=[VideoRecord.from_json(r) for r in raw["query"]],
        gallery=[VideoRecord.from_json(r) for r in raw["gallery"]],
    )


def infer_semantic_dim(semantic_json: str) -> int:
    """Dim inferred from the filename substring, as upstream does
    (dataloader_baseline.py:142-155: checks d300/d200/d1024). We accept any
    ``d{N}`` token so custom embedding files work too, in strictness
    order — the delimited token match must run BEFORE upstream's bare
    substring check, or e.g. ``d2000`` would false-match the ``d200``
    prefix and return 200:

    1. both-side-delimited ``_d300.`` style tokens;
    2. upstream's bare substrings (matches path components like ``d300/``);
    3. right-delimited only (``glove6Bd512.json`` → 512) — the trailing
       boundary means the ``d2`` inside ``word2vec`` can never match
       (followed by a letter)."""
    base = os.path.basename(semantic_json)
    m = re.search(r"(?:^|[^a-zA-Z0-9])d(\d+)(?=[^a-zA-Z0-9]|$)", base)
    if m:
        return int(m.group(1))
    for d in (300, 200, 1024):
        if f"d{d}" in semantic_json:
            return d
    m = re.search(r"d(\d+)(?=[^a-zA-Z0-9]|$)", base)
    if m:
        return int(m.group(1))
    raise ValueError(f"cannot infer embedding dim from {semantic_json!r}")


def load_word_embeddings(
    path: str, cls2int: Dict[str, int], nclass: int, dim: Optional[int] = None
) -> np.ndarray:
    """[nclass, dim] float32, rows L2-normalized (dataloader_baseline.py:157-166).

    Labels absent from cls2int are ignored; classes absent from the JSON stay
    zero (upstream would KeyError — we are permissive and let the caller
    validate)."""
    if dim is None:
        dim = infer_semantic_dim(path)
    with open(path) as f:
        table = json.load(f)
    mem = np.zeros((nclass, dim), dtype=np.float32)
    for label, vec in table.items():
        if label not in cls2int:
            continue
        v = np.asarray(vec, dtype=np.float32).reshape(-1)
        norm = np.linalg.norm(v)
        if norm > 0:
            v = v / norm
        assert v.max() <= 1.0 + 1e-6 and v.min() >= -1.0 - 1e-6
        mem[cls2int[label], :] = v
    return mem
