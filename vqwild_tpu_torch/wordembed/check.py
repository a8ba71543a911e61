"""Embedding-space nearest-neighbor sanity check
(reference word_embed/wordembed_retrieval_test.py): for every class in one
vocabulary, rank classes of another (or the same) vocabulary by negative L2
distance of the L2-normalized vectors.

Host copy of vqwild_tpu/wordembed/check.py."""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


def nearest_neighbor_report(
    embed_json: str,
    against_json: Optional[str] = None,
    topk: int = 5,
) -> Dict[str, List[dict]]:
    with open(embed_json) as f:
        query = json.load(f)
    if against_json:
        with open(against_json) as f:
            gallery = json.load(f)
    else:
        gallery = query

    g_labels = list(gallery.keys())
    g = np.asarray([gallery[l] for l in g_labels], np.float32)
    g = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)

    report = {}
    for label, vec in query.items():
        v = np.asarray(vec, np.float32)
        v = v / max(np.linalg.norm(v), 1e-12)
        scores = -np.linalg.norm(g - v[None], axis=1)
        order = np.argsort(-scores)
        hits = []
        for gi in order[:topk]:
            hits.append(dict(label=g_labels[gi], score=float(scores[gi])))
        report[label] = hits
    return report


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("embed_json")
    p.add_argument("--against", default="")
    p.add_argument("--topk", type=int, default=5)
    args = p.parse_args(argv)
    report = nearest_neighbor_report(args.embed_json, args.against or None, args.topk)
    for label, hits in report.items():
        print(label, "->", ", ".join(f"{h['label']}({h['score']:.3f})" for h in hits))


if __name__ == "__main__":
    main()
