"""ActivityNet v1.3 class labels and ARV meta-split registry.

The reference partitions the 200 activity classes into base (many-shot train)
/ val-novel / test-novel sets per "meta split" (utils_dataset.py:13-38 and
data_generate/activitynet_label_*.py). Two reproduction subtleties, preserved
here as frozen data in ``assets/arv_label_partitions.json`` rather than code:

1. Each upstream partition module runs ``random.seed(620); random.shuffle(...)``
   on the *same shared list object*, and ``data_generate/__init__.py`` imports
   all four modules in a fixed order — so the effective partition of split k is
   the k-th cumulative shuffle (import order: 100_20_80, 80_20_100, 120_20_60,
   40_20_140). We verified the frozen partitions byte-match the upstream
   modules and the ``retrieval_type`` tags in the shipped arv_db JSONs.
2. Upstream registers only three splits in ``dataset_config``; 40_20_140
   exists but is unreachable from the CLI (main.py:65-69). We register all
   four (documented divergence: strictly additive).
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import lru_cache
from typing import Dict, List, Tuple

NOISE_LABEL = "distractor_activity"  # utils_dataset.py:9

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


@lru_cache(maxsize=None)
def _load_asset(name: str):
    with open(os.path.join(_ASSET_DIR, name)) as f:
        return json.load(f)


def activitynet_labels() -> List[str]:
    """The 200 class names in canonical (upstream file) order."""
    return list(_load_asset("activitynet_labels.json"))


ACTIVITYNET_LABELS: Tuple[str, ...] = tuple(activitynet_labels())


@dataclasses.dataclass(frozen=True)
class SplitSpec:
    """One ARV meta split: label partition + dataset JSON locations."""

    name: str
    train_labels: Tuple[str, ...]  # base, many-shot
    val_labels: Tuple[str, ...]  # novel at validation time
    test_labels: Tuple[str, ...]  # novel at test time
    db_json: str  # arv_db_{name}.json, relative to a data root
    moment_db_json: str  # arv_db_{name}_untrimmed.json (v1 — runtime format)

    @property
    def all_labels(self) -> Tuple[str, ...]:
        return self.train_labels + self.val_labels + self.test_labels

    def possible_classes(self, eval_split: str) -> Tuple[str, ...]:
        """Query-label filter per eval split (dataloader_baseline.py:1395-1404).

        validation → train+val labels; testing → train+test labels.
        """
        if eval_split == "validation":
            return self.train_labels + self.val_labels
        if eval_split == "testing":
            return self.train_labels + self.test_labels
        raise ValueError(f"unsupported eval split: {eval_split}")

    def cls2int(self) -> Dict[str, int]:
        """Training label→index map (dataloader_baseline.py:140).

        Index order follows the order labels appear in the training-split JSON
        — which is the insertion order of the (sorted-by-nothing) dict keys.
        The reference builds it from the loaded JSON dict; we rebuild it from
        the same JSON at load time (see TrimmedDB.cls2int). This method gives
        the *partition-order* fallback used when no DB is loaded.
        """
        return {label: i for i, label in enumerate(self.all_labels)}


@lru_cache(maxsize=None)
def split_registry() -> Dict[str, SplitSpec]:
    parts = _load_asset("arv_label_partitions.json")
    registry = {}
    for name, p in parts.items():
        registry[name] = SplitSpec(
            name=name,
            train_labels=tuple(p["train"]),
            val_labels=tuple(p["val"]),
            test_labels=tuple(p["test"]),
            db_json=f"arv_db_{name}.json",
            moment_db_json=f"arv_db_{name}_untrimmed.json",
        )
    return registry


def load_split_file(path: str) -> SplitSpec:
    """A SplitSpec from a user-provided JSON file — custom datasets.

    Schema: {"name", "train_labels", "val_labels", "test_labels",
    "db_json", "moment_db_json"}. Relative db paths resolve against the
    spec file's own directory, so a world directory is self-contained and
    relocatable (``--data_root`` is not needed to find its DBs).
    """
    with open(path) as f:
        d = json.load(f)
    base = os.path.dirname(os.path.abspath(path))

    def _resolve(p: str) -> str:
        # unconditional: a relative path in a spec file means spec-relative.
        # Falling back to the raw name when the file is missing would let a
        # relocated world silently pick up an identically-named DB under
        # --data_root (datagen emits constant filenames) — better to error
        # at the spec-relative path the contract promises.
        if not p or os.path.isabs(p):
            return p
        return os.path.join(base, p)

    return SplitSpec(
        name=d["name"],
        train_labels=tuple(d["train_labels"]),
        val_labels=tuple(d["val_labels"]),
        test_labels=tuple(d["test_labels"]),
        db_json=_resolve(d.get("db_json", "")),
        moment_db_json=_resolve(d.get("moment_db_json", "")),
    )


def get_split(name: str) -> SplitSpec:
    """Registry lookup, or a path to a split-spec JSON (custom datasets)."""
    reg = split_registry()
    if name in reg:
        return reg[name]
    if name.endswith(".json") and os.path.exists(name):
        return load_split_file(name)
    raise KeyError(
        f"unknown meta split {name!r}; known: {sorted(reg)} "
        "(or pass a path to a split-spec JSON)"
    )
