"""The port's offline dataset tools (vqwild_tpu_torch/datagen) against the
JAX package's (vqwild_tpu/datagen), on the same inputs:

- ``segments``, ``splitdb``, ``momentdb`` and ``stats`` on a made-up
  ActivityNet dict of four labels (tests/test_datagen.py) and on one over
  the 200 real labels, through the functions and through both command
  lines: the files they write and the reports they print are byte-equal;
- the label partitions equal both packages' frozen assets;
- ``build_synth_world`` (legacy and semantic) writes byte-equal trees;
- ``frames`` with a stub ``ffmpeg`` on PATH and with none;
- ``pack`` of a tiny JPEG tree, rgb and yuv420, byte-equal;
- the port's command line runs where neither ``jax`` nor ``vqwild_tpu``
  can be imported.
"""

import json
import os
import subprocess
import sys
from multiprocessing.pool import ThreadPool

import numpy as np
import pytest

from tests.test_datagen import synthetic_activitynet
from vqwild_tpu.data import labels as jlabels
from vqwild_tpu.datagen import frames as jframes
from vqwild_tpu.datagen import pipeline as jpipe
from vqwild_tpu.datagen import stats as jstats
from vqwild_tpu.datagen import synthworld as jsynth
from vqwild_tpu.datagen.__main__ import main as jmain
from vqwild_tpu_torch.data import labels as tlabels
from vqwild_tpu_torch.datagen import frames as tframes
from vqwild_tpu_torch.datagen import pipeline as tpipe
from vqwild_tpu_torch.datagen import stats as tstats
from vqwild_tpu_torch.datagen import synthworld as tsynth
from vqwild_tpu_torch.datagen.__main__ import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def activitynet_like(nvid, seed):
    """A seeded annotation dict over the 200 real labels: 1-3 annotations a
    video, durations of 10-240 s, the three ActivityNet subsets."""
    rng = np.random.default_rng(seed)
    labels = tlabels.activitynet_labels()
    db = {}
    for i in range(nvid):
        duration = float(rng.uniform(10, 240))
        anns, t = [], float(rng.uniform(0, 5))
        for _ in range(int(rng.integers(1, 4))):
            length = float(rng.uniform(2, 60))
            if t + length > duration:
                break
            anns.append({"segment": [t, t + length], "label": labels[int(rng.integers(200))]})
            t += length + float(rng.uniform(0, 30))
        db[f"v_{i:05d}"] = {"duration": duration,
                            "subset": ("training", "validation", "testing")[int(rng.integers(3))],
                            "annotations": anns}
    return {"database": db}


@pytest.fixture(params=["toy", "activitynet"])
def world(request, tmp_path):
    """(annotation dict, --meta_split argument, the two packages' SplitSpec)."""
    if request.param == "toy":
        anet, labels = synthetic_activitynet(nvid=40, seed=3)
        spec_path = str(tmp_path / "toy_split.json")
        with open(spec_path, "w") as f:
            json.dump({"name": "toy", "train_labels": labels[:2], "val_labels": labels[2:3],
                       "test_labels": labels[3:], "db_json": "", "moment_db_json": ""}, f)
        meta = spec_path
    else:
        anet, meta = activitynet_like(300, seed=11), "100_20_80"
    return anet, meta, jlabels.get_split(meta), tlabels.get_split(meta)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            out[os.path.relpath(p, root)] = _bytes(p)
    return out


def test_label_partitions_equal_the_frozen_assets():
    got = tpipe.generate_label_partitions(tlabels.ACTIVITYNET_LABELS)
    assert got == jpipe.generate_label_partitions(jlabels.ACTIVITYNET_LABELS)
    for reg in (tlabels.split_registry(), jlabels.split_registry()):
        for name, spec in reg.items():
            assert tuple(got[name]["train"]) == spec.train_labels, name
            assert tuple(got[name]["val"]) == spec.val_labels, name
            assert tuple(got[name]["test"]) == spec.test_labels, name


def test_functions_write_the_same_bytes(world, tmp_path):
    anet, _, jspec, tspec = world
    outs = {}
    for name, pipe, st, spec in (("jax", jpipe, jstats, jspec), ("torch", tpipe, tstats, tspec)):
        segs = pipe.generate_video_segments(anet, seed=7)
        db = pipe.generate_split_db(segs, spec.train_labels, spec.val_labels, spec.test_labels)
        mdb = pipe.generate_moment_db(anet, spec.train_labels, spec.val_labels, spec.test_labels)
        files = {}
        for key, obj in (("segments", segs), ("db", db), ("moment", mdb)):
            path = str(tmp_path / f"{name}_{key}.json")
            pipe.write_json(obj, path)
            files[key] = _bytes(path)
        split = st.split_statistics(db, spec)
        cov = st.moment_coverage(mdb, spec.val_labels)
        outs[name] = (files, json.dumps(split), json.dumps(cov),
                      st.format_split_report(split), st.format_coverage_report(cov))
    assert outs["torch"] == outs["jax"]
    assert len(json.loads(outs["torch"][0]["segments"])) > 0


def test_command_lines_write_the_same_bytes(world, tmp_path, capsys):
    anet, meta, _, _ = world
    anet_path = str(tmp_path / "anet.json")
    with open(anet_path, "w") as f:
        json.dump(anet, f)
    printed = {}
    for name, main in (("jax", jmain), ("torch", tmain)):
        d = tmp_path / name
        d.mkdir()
        seg, db, mdb, rep = (str(d / n) for n in ("seg.json", "db.json", "mdb.json", "rep.json"))
        main(["segments", "--activitynet", anet_path, "--out", seg, "--seed", "5"])
        main(["splitdb", "--segments", seg, "--meta_split", meta, "--out", db])
        main(["momentdb", "--activitynet", anet_path, "--meta_split", meta, "--out", mdb])
        main(["stats", "--db", db, "--untrimmed", mdb, "--meta_split", meta, "--json_out", rep])
        printed[name] = capsys.readouterr().out.replace(str(d), "<out>")
    assert _tree(str(tmp_path / "torch")) == _tree(str(tmp_path / "jax"))
    assert printed["torch"] == printed["jax"]
    assert "clip moment statistics" in printed["torch"]


@pytest.mark.parametrize("semantic", [False, True])
def test_synth_world_writes_the_same_tree(semantic, tmp_path):
    kw = dict(n_base=5, n_val=2, n_test=2, train_per_base=3, embed_dim=16, seed=4,
              semantic=semantic)
    jinfo = jsynth.build_synth_world(str(tmp_path / "jax"), **kw)
    tinfo = tsynth.build_synth_world(str(tmp_path / "torch"), **kw)
    assert _tree(str(tmp_path / "torch")) == _tree(str(tmp_path / "jax"))
    assert len(_tree(str(tmp_path / "torch"))) == (5 if semantic else 4)

    def strip(info):
        return {k: (os.path.relpath(v, info["root"]) if isinstance(v, str) and v else v)
                for k, v in info.items()}

    assert strip(tinfo) == strip(jinfo)


def test_synth_world_command_line(tmp_path, capsys):
    args = ["synthworld", "--n_base", "4", "--n_val", "2", "--n_test", "2",
            "--train_per_base", "2", "--embed_dim", "8", "--semantic"]
    jmain(args + ["--out_dir", str(tmp_path / "jax")])
    jout = capsys.readouterr().out
    tmain(args + ["--out_dir", str(tmp_path / "torch")])
    tout = capsys.readouterr().out
    assert _tree(str(tmp_path / "torch")) == _tree(str(tmp_path / "jax"))
    # the epilogue names each package's own training command
    assert "train: python main.py --meta_split" in jout
    assert "train: python -m vqwild_tpu_torch --meta_split" in tout
    assert (tout.replace(str(tmp_path / "torch"), "<out>")
            .replace("python -m vqwild_tpu_torch", "python main.py")
            == jout.replace(str(tmp_path / "jax"), "<out>"))


STUB_FFMPEG = """#!/bin/sh
for last; do :; done
d="${last%/*}"
: > "$d/image_00001.jpg"
: > "$d/image_00002.jpg"
"""


def test_frames_with_a_stub_ffmpeg_and_without(tmp_path, monkeypatch):
    stub = tmp_path / "bin"
    stub.mkdir()
    (stub / "ffmpeg").write_text(STUB_FFMPEG)
    (stub / "ffmpeg").chmod(0o755)
    monkeypatch.setenv("PATH", str(stub))
    got = {}
    for name, fr in (("jax", jframes), ("torch", tframes)):
        out = tmp_path / name
        one = fr.ffmpeg_extract("v.mp4", str(out / "v0"))
        jobs = [(f"v{i}.mp4", str(out / f"v{i}")) for i in range(1, 4)]
        many = sorted(fr.extract_all(jobs, processes=2, pool_cls=ThreadPool))
        got[name] = (one, [(v, ok, n) for v, ok, n in many], sorted(os.listdir(out / "v2")))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (True, 2)
    assert tframes.extract_all([]) == jframes.extract_all([]) == []

    monkeypatch.setenv("PATH", "")
    jmiss = jframes.ffmpeg_extract("v.mp4", str(tmp_path / "jm"))
    tmiss = tframes.ffmpeg_extract("v.mp4", str(tmp_path / "tm"))
    assert tmiss == jmiss and tmiss[0] is False and "ffmpeg" in tmiss[1]


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_pack_writes_the_same_bytes(fmt, tmp_path, capsys):
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path / "jpeg"
    for subset, vids in (("training", ("va", "vb")), ("validation", ("vc",))):
        for vid in vids:
            d = root / subset / vid
            d.mkdir(parents=True)
            for k in range(1, 4):
                img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
                Image.fromarray(img).save(d / f"image_{k:05d}.jpg", quality=90)
    for name, main in (("jax", jmain), ("torch", tmain)):
        main(["pack", "--jpeg_root", str(root), "--out_root", str(tmp_path / name),
              "--format", fmt])
    capsys.readouterr()
    packed = _tree(str(tmp_path / "torch"))
    assert packed == _tree(str(tmp_path / "jax"))
    assert len(packed) == (4 if fmt == "rgb" else 6)


def test_command_line_runs_without_jax(tmp_path):
    anet_path = str(tmp_path / "anet.json")
    with open(anet_path, "w") as f:
        json.dump(activitynet_like(30, seed=2), f)
    out = str(tmp_path / "seg.json")
    code = (
        "import runpy, sys\n"
        "for m in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'vqwild_tpu')]:\n"
        "    del sys.modules[m]\n"
        "for m in ('jax', 'jaxlib', 'vqwild_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['datagen', 'segments', '--activitynet', {anet_path!r}, '--out', {out!r}]\n"
        "runpy.run_module('vqwild_tpu_torch.datagen', run_name='__main__')\n"
        "assert not [k for k in sys.modules if k.split('.')[0] in ('jax', 'vqwild_tpu')"
        " and sys.modules[k] is not None]\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("total=")
    segs = jpipe.generate_video_segments(activitynet_like(30, seed=2), seed=620)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(segs))
