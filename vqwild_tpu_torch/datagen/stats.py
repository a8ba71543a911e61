"""Dataset statistics / design-analysis reports for the offline pipeline.

Host copy of vqwild_tpu/datagen/stats.py: the same inputs give the same
output bytes.

Reproduces the analyses the reference prints when (re)generating the DBs —
the numbers that motivated its design choices — as pure functions over the
emitted JSON artifacts, so a user can re-derive them from any DB file:

* split statistics (1_generate_trainvaltest.py:172-275): per-class sample
  counts, videos-per-class histogram, total = non-noise + noise, foreground
  duration histogram, fg/bg-ratio histogram, per ARV subset. (The matplotlib
  PNG overlays of the same histograms, :277-328, are intentionally omitted —
  the numbers are the analysis; documented divergence.)
* moment tIoU coverage (2_generate_moment_test.py:79-159): for each
  (clip_sec, max_clips_per_moment) design point, the fraction of gallery
  annotations whose closest representable moment reaches tIoU > 0.5 / 0.7 —
  the grid search that selected clip_sec=5, max 26 clips.
* untrimmed gallery summary (2_generate_moment_test.py:56-72): query and
  gallery counts, mean gallery video duration, mean annotation duration.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

from vqwild_tpu_torch.data.labels import NOISE_LABEL
from vqwild_tpu_torch.data.sampling import temporal_iou

VIDEOS_PER_CLASS_BINS = [0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 110, 120]
FG_DURATION_BINS = [0, 20, 40, 60, 80, 100, 120, 140, 160, 180, 200, 220, 240, 260]
FG_BG_RATIO_BINS = [0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1]


def _hist(values: Sequence[float], bins: Sequence[float]) -> Dict:
    counts, edges = np.histogram(np.asarray(values, np.float64), bins=bins)
    return {"counts": counts.tolist(), "bins": list(edges.tolist())}


def split_statistics(db: Dict[str, Dict[str, list]], spec) -> Dict:
    """Per-subset report over a trimmed split DB ({subset: {label: [rec]}}).

    spec: data.labels.SplitSpec (label partition). Mirrors the printed
    statistics block of 1_generate_trainvaltest.py:172-275.
    """
    out: Dict[str, Dict] = {}
    for subset in ("training", "validation", "testing"):
        d = db.get(subset, {})
        noise = d.get(NOISE_LABEL, [])
        class_counts = {
            "base": {l: len(d.get(l, [])) for l in spec.train_labels},
            "novel_val": {l: len(d.get(l, [])) for l in spec.val_labels},
            "novel_test": {l: len(d.get(l, [])) for l in spec.test_labels},
            "noise": {NOISE_LABEL: len(noise)},
        }
        per_class = [len(v) for v in d.values()]
        total = sum(per_class)
        fg, ratio = [], []
        for label in spec.all_labels:
            for rec in d.get(label, []):
                seg, border = rec["segment"], rec["border"]
                fg.append(seg[1] - seg[0])
                ratio.append((seg[1] - seg[0]) / (border[1] - border[0]))
        out[subset] = {
            "class_counts": class_counts,
            "total_videos": total,
            "non_noise_videos": total - len(noise),
            "noise_videos": len(noise),
            "videos_per_class_hist": _hist(per_class, VIDEOS_PER_CLASS_BINS),
            "fg_duration_hist": _hist(fg, FG_DURATION_BINS),
            "fg_bg_ratio_hist": _hist(ratio, FG_BG_RATIO_BINS),
        }
    return out


def _closest_moment_ious(
    gallery: Iterable[dict],
    clip_sec: float,
    max_clips_per_moment: int,
    excluded_labels: Sequence[str],
) -> List[float]:
    """find_closest_moment (2_generate_moment_test.py:79-138): best tIoU of
    each annotation against the moment grid, in CLIP-INDEX space (upstream
    divides by clip_sec and checks the four integer-snapped candidates)."""
    iou = temporal_iou

    excluded = set(excluded_labels)
    ious: List[float] = []
    for g in gallery:
        for ann in g["annotations"]:
            a = ann["segment"][0] / clip_sec
            b = ann["segment"][1] / clip_sec
            if a == b:
                continue  # degenerate ActivityNet annotation
            if ann["label"] in excluded:
                continue
            if b - a < max_clips_per_moment:
                best = max(
                    iou(a, b, int(a), int(b)),
                    iou(a, b, int(a) + 1, int(b)),
                    iou(a, b, int(a), int(b) + 1),
                    iou(a, b, int(a) + 1, int(b) + 1),
                )
            else:
                best = max_clips_per_moment / (b - a)
            assert best <= 1
            ious.append(best)
    return ious


def moment_coverage(
    moment_db: Dict[str, list],
    val_labels: Sequence[str],
    clip_secs: Sequence[int] = (5, 7, 9),
    max_clips: Sequence[int] = (14, 20, 26),
) -> Dict:
    """The clip/moment design grid (2_generate_moment_test.py:141-159):
    coverage@tIoU{0.5,0.7} for each (clip_sec, max_clips_per_moment)."""
    gallery = moment_db["gallery"]
    grid = []
    for c in clip_secs:
        for m in max_clips:
            ious = np.asarray(
                _closest_moment_ious(gallery, c, m, val_labels), np.float64
            )
            npos = max(len(ious), 1)
            grid.append(
                {
                    "clip_sec": c,
                    "max_clips_per_moment": m,
                    "iou05": float(np.sum(ious > 0.5)) / npos,
                    "iou07": float(np.sum(ious > 0.7)) / npos,
                    "annotations": int(len(ious)),
                }
            )
    durations = [g["activitynet_duration"] for g in gallery]
    ann_durations = [
        a["segment"][1] - a["segment"][0]
        for g in gallery
        for a in g["annotations"]
    ]
    return {
        "query_number": len(moment_db["query"]),
        "gallery_number": len(gallery),
        "avg_gallery_video_duration_sec": float(np.mean(durations)) if durations else 0.0,
        "avg_annotation_duration_sec": float(np.mean(ann_durations)) if ann_durations else 0.0,
        "coverage_grid": grid,
    }


def format_split_report(stats: Dict) -> str:
    lines = []
    for subset, s in stats.items():
        lines.append(f"== {subset} ==")
        lines.append(
            "total = non-noise + noise: {} = {} + {}".format(
                s["total_videos"], s["non_noise_videos"], s["noise_videos"]
            )
        )
        for name in ("videos_per_class_hist", "fg_duration_hist", "fg_bg_ratio_hist"):
            h = s[name]
            lines.append(f"{name}: counts={h['counts']} bins={h['bins']}")
    return "\n".join(lines)


def format_coverage_report(cov: Dict) -> str:
    lines = [
        "query number={}, gallery number={}".format(
            cov["query_number"], cov["gallery_number"]
        ),
        "average video duration in gallery= {:.4f} seconds".format(
            cov["avg_gallery_video_duration_sec"]
        ),
        "average activity duration in gallery= {:.4f} seconds".format(
            cov["avg_annotation_duration_sec"]
        ),
        "clip moment statistics",
    ]
    for g in cov["coverage_grid"]:
        lines.append(
            "iou0.5={}, iou0.7={}, clip_sec={}, max_clip_per_moment={}".format(
                g["iou05"], g["iou07"], g["clip_sec"], g["max_clips_per_moment"]
            )
        )
    return "\n".join(lines)
