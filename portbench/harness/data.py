"""Data a cell needs on disk, under ``portbench/.cache/data/<hash>/``.

Written by the first run that lacks it, into a temporary directory renamed
into place, and reused by later runs; the hash covers every parameter the
files depend on and the device kind that drew them. The training store is
the program's packed 4:2:0 layout ({subset}.y.bin, {subset}.uv.bin,
{subset}.json), one seeded video of low-frequency frames per class, with a
trimmed DB and a split spec in the reference's JSON schema.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

from portbench.harness.traffic import DATA_SEED, ROLE_GALLERY, rng

SUBSET = "training"


def _key(params: dict) -> str:
    return hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]


def label_names(nclass: int):
    return [f"activity_{i:03d}" for i in range(nclass)]


def video_id(label: int) -> str:
    return f"v_{label:05d}"


def train_records(nclass: int, frames: int, fps: int):
    """One record per class, in class order: (label name, video id,
    segment [s0, s1] in seconds)."""
    r = rng(DATA_SEED, ROLE_GALLERY)
    dur = frames / fps
    out = []
    for i, name in enumerate(label_names(nclass)):
        length = float(r.uniform(8.0, 14.0))
        start = float(r.uniform(0.0, max(0.0, dur - length - 1.0)))
        out.append((name, video_id(i), [start, start + length]))
    return out


def _write_store(torch, device, root: str, nclass: int, frames: int, h: int, w: int) -> None:
    hp, wp = h + h % 2, w + w % 2
    gen = torch.Generator(device=device).manual_seed(DATA_SEED)
    index = {}
    with open(os.path.join(root, SUBSET + ".y.bin"), "wb") as yb, \
            open(os.path.join(root, SUBSET + ".uv.bin"), "wb") as uvb:
        for i in range(nclass):
            base = torch.randn(frames, -(-hp // 4), -(-wp // 4), generator=gen, device=device)
            y = base.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :hp, :wp]
            y = (127 + 60 * torch.tanh(y)).clamp(0, 255).to(torch.uint8)
            c = torch.randn(frames, -(-hp // 8), -(-wp // 8), 2, generator=gen, device=device)
            uv = c.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :hp // 2, :wp // 2]
            uv = (128 + 30 * torch.tanh(uv)).clamp(0, 255).to(torch.uint8)
            yb.write(y.cpu().numpy().tobytes())
            uvb.write(uv.cpu().numpy().tobytes())
            index[video_id(i)] = {"offset": i * frames, "n": frames}
    with open(os.path.join(root, SUBSET + ".json"), "w") as f:
        json.dump({"_meta": {"h": h, "w": w, "hp": hp, "wp": wp}, "videos": index}, f)


def _write_db(root: str, nclass: int, frames: int, fps: int, split) -> None:
    names = label_names(nclass)
    training = {}
    for name, vid, seg in train_records(nclass, frames, fps):
        training[name] = [{"video_id": vid, "label": name, "segment": seg, "border": seg,
                           "activitynet_subset": SUBSET, "activitynet_duration": frames / fps,
                           "is_query": 0, "retrieval_type": "base"}]
    with open(os.path.join(root, "arv_db_train.json"), "w") as f:
        json.dump({"training": training, "validation": {}, "testing": {}}, f)
    a, b = split
    with open(os.path.join(root, "split.json"), "w") as f:
        json.dump({"name": "portbench", "train_labels": names[:a],
                   "val_labels": names[a:a + b], "test_labels": names[a + b:],
                   "db_json": "arv_db_train.json", "moment_db_json": ""}, f)


def train_store(torch, device, cache_dir: str, p: dict) -> str:
    """The training store's directory (written if absent): the packed
    store, ``arv_db_train.json`` and ``split.json``."""
    if p["train_videos"] != p["nclass"]:
        raise SystemExit("portbench: the training store holds one video per class")
    spec = {"kind": "train_store", "nclass": p["nclass"], "frames": p["store_frames"],
            "h": p["frame_h"], "w": p["frame_w"], "fps": p["fps"], "split": p["split"],
            "device": device.type, "seed": DATA_SEED}
    root = os.path.join(cache_dir, "data", _key(spec))
    if os.path.exists(os.path.join(root, "done")):
        return root
    tmp = root + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    _write_store(torch, device, tmp, p["nclass"], p["store_frames"], p["frame_h"], p["frame_w"])
    _write_db(tmp, p["nclass"], p["store_frames"], p["fps"], p["split"])
    with open(os.path.join(tmp, "done"), "w") as f:
        json.dump(spec, f)
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)
    return root


def store_planes(root: str):
    """(Y [N, hp, wp], UV [N, hp/2, wp/2, 2] memmaps, index document)."""
    with open(os.path.join(root, SUBSET + ".json")) as f:
        doc = json.load(f)
    m = doc["_meta"]
    y = np.memmap(os.path.join(root, SUBSET + ".y.bin"), np.uint8, "r").reshape(-1, m["hp"], m["wp"])
    uv = np.memmap(os.path.join(root, SUBSET + ".uv.bin"), np.uint8, "r").reshape(
        -1, m["hp"] // 2, m["wp"] // 2, 2)
    return y, uv, doc
