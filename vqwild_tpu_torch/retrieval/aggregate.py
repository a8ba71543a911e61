"""Metric aggregation — the evaluation_metric accumulator + get_result port.

Reproduces the reference's aggregation semantics exactly
(dataloader_baseline.py:325-658), including its weighting quirks:

* "1-order" = mean over queries; "2-order" = mean over per-class means —
  BUT the 2-order base/novel means iterate ``self.base_classes`` /
  ``self.novel_classes`` which contain one entry *per query*, so classes are
  weighted by their query count (duplicates preserved, :533-548, :585-595).
  Only ``o2_class_specific_map`` averages over unique classes (:584).
* ``Average`` uses a +1e-10 denominator (never NaN on empty, :291-293).
* headline ``ap`` = scipy-style harmonic mean of (2-order base mAP + 1e-10,
  2-order novel mAP + 1e-10) (:590-595).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from vqwild_tpu_torch.core.logging import get_logger

log = get_logger("retrieval.aggregate")


def _average(vals: Sequence[float]) -> float:
    return float(sum(vals) / (len(vals) + 1e-10))


def _hmean2(a: float, b: float) -> float:
    a += 1e-10
    b += 1e-10
    return 2.0 / (1.0 / a + 1.0 / b)


class MetricAggregator:
    def __init__(self, r_at_n: Sequence[int] = (30, 50, 100)):
        self.r_at_n = tuple(r_at_n)
        self.class_dict: Dict[str, List[float]] = {}
        self.class_agnostic_ap: List[float] = []
        self.base_classes: List[str] = []  # one entry per base query
        self.novel_classes: List[str] = []  # one entry per novel query
        self.full_top: Dict[int, List[float]] = {n: [] for n in self.r_at_n}
        self.base_top: Dict[int, List[float]] = {n: [] for n in self.r_at_n}
        self.novel_top: Dict[int, List[float]] = {n: [] for n in self.r_at_n}
        self.per_class_top: Dict[int, Dict[str, List[float]]] = {
            n: {} for n in self.r_at_n
        }

    def set_class_info(self, query_infos: Sequence):
        """query_infos: iterable of (cls_name, retrieval_type) — one per query
        (evaluation_metric.set_class_info, :375-390)."""
        for cls_name, rtype in query_infos:
            if rtype == "base":
                self.base_classes.append(cls_name)
            elif rtype == "novel":
                self.novel_classes.append(cls_name)
            else:
                raise ValueError(f"query retrieval_type must be base/novel, got {rtype}")

    def add(self, cls_name: str, retrieval_type: str, ap: float, recalls: Sequence[float]):
        self.class_agnostic_ap.append(float(ap))
        self.class_dict.setdefault(cls_name, []).append(float(ap))
        for n, r in zip(self.r_at_n, recalls):
            r = float(r)
            self.full_top[n].append(r)
            self.per_class_top[n].setdefault(cls_name, []).append(r)
            if retrieval_type == "base":
                self.base_top[n].append(r)
            elif retrieval_type == "novel":
                self.novel_top[n].append(r)
            else:
                raise ValueError(retrieval_type)

    def result(self) -> dict:
        recall = {}
        base_recall = {}
        novel_recall = {}
        recall2 = {}
        for n in self.r_at_n:
            recall[str(n)] = _average(self.full_top[n])
            base_recall[str(n)] = _average(self.base_top[n])
            novel_recall[str(n)] = _average(self.novel_top[n])
            per_class = {c: _average(v) for c, v in self.per_class_top[n].items()}
            # query-count-weighted class means (upstream duplicate lists)
            recall2[str(n)] = dict(
                full=_average(
                    [per_class[c] for c in (self.novel_classes + self.base_classes)]
                ),
                base=_average([per_class[c] for c in self.base_classes]),
                novel=_average([per_class[c] for c in self.novel_classes]),
            )

        base_ap_list = [ap for c in self.base_classes for ap in self.class_dict[c]]
        novel_ap_list = [ap for c in self.novel_classes for ap in self.class_dict[c]]
        class_map = {c: _average(v) for c, v in self.class_dict.items()}

        o1_agnostic = _average(self.class_agnostic_ap)
        o1_base = _average(base_ap_list)
        o1_novel = _average(novel_ap_list)
        o2_base = _average([class_map[c] for c in self.base_classes])
        o2_novel = _average([class_map[c] for c in self.novel_classes])
        o2_map = _average(list(class_map.values()))
        o2_hmean = _hmean2(o2_base, o2_novel)

        log.info("1-order class_agnostic_map=%.4f", o1_agnostic * 100)
        log.warning("(report metric) 2-order harmonic map=%.4f", o2_hmean * 100)
        log.warning("(report metric) 2-order base map=%.4f", o2_base * 100)
        log.warning("(report metric) 2-order novel map=%.4f", o2_novel * 100)

        return dict(
            ap=o2_hmean,
            base_map=o2_base,
            novel_map=o2_novel,
            recall=recall,
            base_recall=base_recall,
            novel_recall=novel_recall,
            recall_2order=recall2,
            o1_hmean=_hmean2(o1_base, o1_novel),
            o1_class_specific_base_map=o1_base,
            o1_class_specific_novel_map=o1_novel,
            o1_class_specific_map=_average(base_ap_list + novel_ap_list),
            o1_class_agnostic_map=o1_agnostic,
            o2_class_specific_map=o2_map,
            class_map_dict=class_map,
        )


@dataclasses.dataclass
class QueryResult:
    cls_name: str
    retrieval_type: str
    ap: float
    recalls: List[float]


def aggregate_query_results(
    results: Sequence[QueryResult], r_at_n: Sequence[int] = (30, 50, 100)
) -> dict:
    agg = MetricAggregator(r_at_n)
    agg.set_class_info([(r.cls_name, r.retrieval_type) for r in results])
    for r in results:
        agg.add(r.cls_name, r.retrieval_type, r.ap, r.recalls)
    return agg.result()
