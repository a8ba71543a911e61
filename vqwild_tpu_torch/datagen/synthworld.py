"""Learnable synthetic ARV world — end-to-end recipe validation without
ActivityNet on disk.

Host copy of vqwild_tpu/datagen/synthworld.py: the same inputs give the same
output bytes.

The reference's de-facto integration test is "run the real pipeline"
(run_all.sh:3-15); with ActivityNet frames absent in this environment the
equivalent is a procedurally generated world whose *pixels carry the class
signal*: every class owns a texture loop, every video a private warp of it
(data/frames.py:ClassSyntheticFrameStore), and the DB JSONs emitted here
agree exactly with those deterministic functions — so the full CLI recipe
(triplet CE training → trimmed/clip/moment retrieval eval → best-checkpoint
selection) can be driven to measurable convergence.

Emits into ``out_dir``:
  arv_db_synth.json            trimmed split DB (schema of arv_db_*.json)
  arv_db_synth_untrimmed.json  moment DB (v1 runtime schema)
  wordembed_synth_d{D}.json    class embeddings (vasa)
  synth_split.json             SplitSpec file for --meta_split <path>
  synth_semantics.json         (semantic mode only) latent/atom spec the
                               frame store renders from

Semantic mode (``semantic=True``) builds the world the reference's
*scientific claim* needs (resnet18_vasa.py:217-229 — semantic alignment
improving few-shot novel retrieval): every class owns a latent vector
``s_c`` in R^K; frame textures are LINEAR in ``s_c`` over a shared bank of
K spatio-temporal sinusoid atoms, and the vasa word embeddings are an
orthonormal image ``Q s_c`` of the same latent — so word-embedding geometry
IS visual-generative geometry. Novel (val/test) classes are grouped into
tight sibling families around shared centers: separating siblings needs a
metrically faithful encoding of s, which few-shot triplet training alone
(novel_num examples per novel class) underdetermines — the signal the
va/vasa auxiliary losses exist to supply.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from vqwild_tpu_torch.data.frames import synth_schedule, synth_video_frames
from vqwild_tpu_torch.data.labels import NOISE_LABEL

FPS = 3


def _label(i: int) -> str:
    return f"synth_{i:03d}"


def _record(video_id, label, subset, seg, is_query=0, rtype="base",
            annotations=None):
    duration = synth_video_frames(video_id) / FPS
    r = dict(
        video_id=video_id,
        label=label,
        segment=[float(seg[0]), float(seg[1])],
        border=[float(seg[0]), float(seg[1])],
        activitynet_subset=subset,
        activitynet_duration=duration,
        is_query=is_query,
        retrieval_type=rtype,
    )
    if annotations is not None:
        r["annotations"] = annotations
    return r


def _class_video(cls: int, counter: List[int], subset, is_query=0,
                 rtype="base"):
    counter[0] += 1
    vid = f"sc{cls:03d}_{counter[0]:05d}"
    duration = synth_video_frames(vid) / FPS
    # whole tape is class content; segment = essentially the full video,
    # kept >10.5 s so every record is also a valid moment query
    seg = (0.5, max(11.0, duration - 0.3))
    return _record(vid, _label(cls), subset, seg, is_query, rtype)


def _noise_video(counter: List[int], subset, is_query=0):
    counter[0] += 1
    vid = f"sn_{counter[0]:05d}"
    duration = synth_video_frames(vid) / FPS
    return _record(vid, NOISE_LABEL, subset, (0.5, duration - 0.3),
                   is_query, "noise")


def build_semantics(
    n_base: int,
    n_novel: int,
    latent_dim: int = 8,
    family_size: int = 2,
    sibling_eps: float = 0.35,
    texture_amp: float = 16.0,
    loop: int = 16,
    seed: int = 0,
) -> Dict:
    """Latent/atom spec for the semantically coupled world.

    - atom bank: ``latent_dim`` spatio-temporal sinusoids (frequency, drift
      velocity, per-channel phase) shared by every class;
    - base classes: random unit latents (span the space);
    - novel classes: families of ``family_size`` siblings around a shared
      unit center, offset by ``sibling_eps`` along a random orthogonal
      direction then re-normalized — siblings are visually confusable by
      construction, in proportion to eps.

    Texture of class c at (t, y, x, ch) =
        sum_j texture_amp * s_cj * sin(2pi(fy_j y + fx_j x + vel_j t/L)
                                       + phase_j[ch])
    i.e. appearance is LINEAR in s_c, so an encoder that recovers s (which
    the vasa word-CE supervises, since word embeds are Q s) induces the
    correct retrieval metric for never-abundantly-seen novel classes.
    """
    rng = np.random.default_rng(seed + 77_777)
    atoms = []
    for _ in range(latent_dim):
        atoms.append(
            dict(
                fy=float(rng.uniform(0.03, 0.28)),
                fx=float(rng.uniform(0.03, 0.28)),
                vel=int(rng.integers(1, loop)),
                phase=[float(x) for x in rng.uniform(0, 2 * np.pi, size=3)],
            )
        )

    def unit(v):
        return v / np.linalg.norm(v)

    lat = np.zeros((n_base + n_novel, latent_dim), np.float64)
    for c in range(n_base):
        lat[c] = unit(rng.normal(size=latent_dim))
    fam_of = {}
    for k, c in enumerate(range(n_base, n_base + n_novel)):
        fam = k // family_size
        fam_of[c] = fam
        if k % family_size == 0:
            center = unit(rng.normal(size=latent_dim))
        d = rng.normal(size=latent_dim)
        d -= center * (d @ center)  # orthogonal offset: pure direction change
        lat[c] = unit(center + sibling_eps * unit(d))

    return dict(
        version=1,
        latent_dim=latent_dim,
        loop=loop,
        texture_amp=texture_amp,
        family_size=family_size,
        sibling_eps=sibling_eps,
        seed=seed,
        atoms=atoms,
        latents=[[float(x) for x in row] for row in lat],
        novel_family={str(c): f for c, f in fam_of.items()},
    )


def semantic_word_embeddings(
    sem: Dict, embed_dim: int, seed: int
) -> np.ndarray:
    """Word embeddings = orthonormal lift Q s_c of the visual latents.

    Q's columns are orthonormal (QR of a seeded Gaussian), so cosine/L2
    geometry among word embeddings equals that of the generative latents —
    the coupling the vasa semantic memory (models/arv.py) can exploit.
    """
    lat = np.asarray(sem["latents"], np.float64)
    k = lat.shape[1]
    if embed_dim < k:
        raise ValueError(f"embed_dim {embed_dim} < latent_dim {k}")
    rng = np.random.default_rng(seed + 13_131)
    q, _ = np.linalg.qr(rng.normal(size=(embed_dim, k)))
    return lat @ q.T


def build_synth_world(
    out_dir: str,
    n_base: int = 16,
    n_val: int = 4,
    n_test: int = 4,
    train_per_base: int = 12,
    train_per_novel: int = 8,
    eval_per_class: int = 6,
    queries_per_class: int = 3,
    n_noise_train: int = 12,
    n_noise_eval: int = 4,
    min_gallery: int = 24,
    embed_dim: int = 64,
    seed: int = 0,
    semantic: bool = False,
    latent_dim: int = 8,
    family_size: int = 2,
    sibling_eps: float = 0.35,
    texture_amp: float = 16.0,
) -> Dict:
    ncls = n_base + n_val + n_test
    labels = [_label(i) for i in range(ncls)]
    base = labels[:n_base]
    val_novel = labels[n_base:n_base + n_val]
    test_novel = labels[n_base + n_val:]
    counter = [0]

    trimmed = {"training": {}, "validation": {}, "testing": {}}
    for cls, label in enumerate(labels):
        n = train_per_base if label in base else train_per_novel
        trimmed["training"][label] = [
            _class_video(cls, counter, "training") for _ in range(n)
        ]
    trimmed["training"][NOISE_LABEL] = [
        _noise_video(counter, "training") for _ in range(n_noise_train)
    ]

    for split in ("validation", "testing"):
        for cls, label in enumerate(labels):
            rtype = "base" if label in base else "novel"
            trimmed[split][label] = [
                _class_video(cls, counter, "validation",
                             is_query=1 if i < queries_per_class else 0,
                             rtype=rtype)
                for i in range(eval_per_class)
            ]
        trimmed[split][NOISE_LABEL] = [
            _noise_video(counter, "validation", is_query=-1)
            for _ in range(n_noise_eval)
        ]

    # moment DB: queries = per-class trimmed segments (>10 s by
    # construction); gallery = untrimmed sg videos whose annotation lists
    # are exactly synth_schedule() — grown until every class is covered
    # (the evaluators assert gallery class-completeness,
    # dataloader_baseline.py:862-870, :1186-1194)
    queries = []
    for cls, label in enumerate(labels):
        rtype = "base" if label in base else "novel"
        for _ in range(queries_per_class):
            queries.append(
                _class_video(cls, counter, "validation", rtype=rtype)
            )
    queries.append(_noise_video(counter, "validation"))

    gallery, covered, gi = [], set(), 0
    while gi < min_gallery or len(covered) < ncls:
        gi += 1
        if gi > min_gallery + 40 * ncls:  # deterministic, but bound it
            raise RuntimeError("gallery class coverage did not close")
        vid = f"sg{ncls:03d}_{gi:05d}"
        anns = []
        for f0, f1, cls in synth_schedule(vid, ncls):
            anns.append(
                {"segment": [f0 / FPS, f1 / FPS], "label": _label(cls)}
            )
            covered.add(cls)
        if not anns:
            continue
        duration = synth_video_frames(vid) / FPS
        gallery.append(
            _record(vid, "", "validation", (0.0, duration), annotations=anns)
        )

    os.makedirs(out_dir, exist_ok=True)
    sem = None
    if semantic:
        sem = build_semantics(
            n_base,
            n_val + n_test,
            latent_dim=latent_dim,
            family_size=family_size,
            sibling_eps=sibling_eps,
            texture_amp=texture_amp,
            seed=seed,
        )
        with open(os.path.join(out_dir, "synth_semantics.json"), "w") as f:
            json.dump(sem, f)
        w = semantic_word_embeddings(sem, embed_dim, seed)
        embeds = {label: w[i].tolist() for i, label in enumerate(labels)}
    else:
        rng = np.random.default_rng(seed)
        embeds = {
            label: rng.normal(size=embed_dim).tolist() for label in labels
        }

    db_path = os.path.join(out_dir, "arv_db_synth.json")
    moment_path = os.path.join(out_dir, "arv_db_synth_untrimmed.json")
    embed_path = os.path.join(out_dir, f"wordembed_synth_d{embed_dim}.json")
    spec_path = os.path.join(out_dir, "synth_split.json")
    with open(db_path, "w") as f:
        json.dump(trimmed, f)
    with open(moment_path, "w") as f:
        json.dump({"query": queries, "gallery": gallery}, f)
    with open(embed_path, "w") as f:
        json.dump(embeds, f)
    with open(spec_path, "w") as f:
        json.dump(
            dict(
                name="synth",
                train_labels=base,
                val_labels=val_novel,
                test_labels=test_novel,
                db_json="arv_db_synth.json",
                moment_db_json="arv_db_synth_untrimmed.json",
            ),
            f,
        )
    return dict(
        root=out_dir,
        spec_path=spec_path,
        db_path=db_path,
        moment_path=moment_path,
        embed_path=embed_path,
        embed_dim=embed_dim,
        nclass=ncls,
        labels=labels,
        n_gallery=len(gallery),
        semantic=bool(semantic),
        semantics_path=(
            os.path.join(out_dir, "synth_semantics.json") if semantic else ""
        ),
    )
