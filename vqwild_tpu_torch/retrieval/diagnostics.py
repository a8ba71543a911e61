"""Shared cm_dict diagnostics payload for all three evaluators.

Upstream collects this payload through the shared ``evaluation_metric``
accumulator (dataloader_baseline.py:357-368, :437-466, :638-648), but each
evaluator fills only the fields its scored dicts carry:

* trimmed fills everything (dicts carry gt_label/label/frame-info/duration,
  :1537-1586);
* clip fills ``gt_labels`` + the system y_true/y_pred stream only (its dicts
  carry just gt_label/tp/ignore/score, :911-927);
* moment's multiprocessing path bypasses ``add2dict`` entirely
  (``multiprocess_calculate``, :386-402) and collects nothing.

The rebuild fills the *full* payload for all three — a documented superset:
every field upstream ever emits is emitted with identical semantics, and the
fields upstream leaves empty for clip/moment are populated instead of blank.
The system stream is accumulated as numpy chunks, not Python lists — at ARV
scale it is Q×G ≈ 10^8 entries.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_SYS_KEYS = (
    "y_true",
    "y_pred",
    "base_y_true",
    "base_y_pred",
    "novel_y_true",
    "novel_y_pred",
)


class DiagnosticsCollector:
    """Accumulates the per-query confusion / top-N / system-AP diagnostics
    (``evaluation_metric.add2dict``, dataloader_baseline.py:437-466)."""

    def __init__(self, robust: bool = True):
        self.robust = robust
        self.gt_labels: list = []
        self.label: list = []
        self.top30_result_list: list = []
        self.query_duration_map_dict: dict = {}
        self._sys = {k: [] for k in _SYS_KEYS}

    def add(
        self,
        *,
        gt_label: str,
        retrieval_type: str,
        duration_sec: float,
        ap: float,
        y_true: np.ndarray,
        y_pred: np.ndarray,
        top_labels: Optional[Sequence[str]] = None,
        top30_items: Optional[Sequence[dict]] = None,
    ) -> None:
        """One ranked query.

        ``y_true``/``y_pred`` are the query's ignore-filtered ranked stream
        with *pre-robust* labels; the trailing-tp flip (:434) is applied here
        on a copy, exactly as upstream mutates its numpy copy.
        ``top_labels`` are the labels of the first ≤100 ranked candidates
        (:437-446); ``top30_items`` the first ≤30 result descriptors (:457).
        """
        yt = np.asarray(y_true, np.int8).copy()
        if self.robust and yt.size:
            yt[-1] = 1
        yp = np.asarray(y_pred, np.float32)
        self._sys["y_true"].append(yt)
        self._sys["y_pred"].append(yp)
        self._sys[f"{retrieval_type}_y_true"].append(yt)
        self._sys[f"{retrieval_type}_y_pred"].append(yp)
        if top_labels is not None:
            self.gt_labels.extend([gt_label] * len(top_labels))
            self.label.extend(top_labels)
        if top30_items is not None:
            self.top30_result_list.append(list(top30_items[:30]))
        self.query_duration_map_dict[duration_sec] = float(ap)

    def finalize(self, agg, result: dict, pass_content=()) -> dict:
        """Assemble the cm_dict exactly as ``get_result`` does (:638-648).

        ``agg`` is the MetricAggregator (for base/novel class lists),
        ``result`` its ``result()`` dict (for class_map_dict).
        """
        return dict(
            gt_labels=self.gt_labels,
            label=self.label,
            base_classes=agg.base_classes,
            novel_classes=agg.novel_classes,
            query_duration_map_dict=self.query_duration_map_dict,
            system_ap_dict={
                k: (
                    np.concatenate(v)
                    if v
                    else np.empty(
                        0, np.float32 if k.endswith("y_pred") else np.int8
                    )
                )
                for k, v in self._sys.items()
            },
            class_map_dict=result["class_map_dict"],
            top30_result_list=self.top30_result_list,
            pass_content=list(pass_content),
        )
