"""Port's data layer (vqwild_tpu_torch/data, the host half of
ops/preprocess.py, and the small host modules that came with it) against
the JAX package's. All of it is numpy and the standard library, so every
comparison is exact: the same inputs give equal records and equal arrays."""

import dataclasses
import filecmp
import json
import time
from pathlib import Path

import numpy as np
import pytest

from vqwild_tpu.core import config as jconfig
from vqwild_tpu.core import meters as jmeters
from vqwild_tpu.data import clips as jclips
from vqwild_tpu.data import frames as jframes
from vqwild_tpu.data import labels as jlabels
from vqwild_tpu.data import sampling as jsampling
from vqwild_tpu.data import schema as jschema
from vqwild_tpu.data import transforms as jtransforms
from vqwild_tpu.ops import hostmem as jhostmem
from vqwild_tpu.ops import metrics_np as jmetrics_np
from vqwild_tpu.ops import preprocess as jpre
from vqwild_tpu.retrieval import multiquery as jmultiquery
from vqwild_tpu_torch.apps import cli
from vqwild_tpu_torch.core import config, meters
from vqwild_tpu_torch.core.profiling import phase
from vqwild_tpu_torch.data import clips, frames, labels, sampling, schema, transforms
from vqwild_tpu_torch.ops import hostmem, metrics_np
from vqwild_tpu_torch.ops import preprocess as pre
from vqwild_tpu_torch.retrieval import multiquery

REPO = Path(__file__).resolve().parent.parent
SPLITS = ("training", "validation", "testing")


def _as_dict(obj):
    return dataclasses.asdict(obj)


def write_split_spec(tiny_arv, path) -> str:
    """tiny_arv's SplitSpec as a split-spec JSON file (the custom-dataset
    form of ``--meta_split``)."""
    spec = tiny_arv["spec"]
    doc = {"name": spec.name, "train_labels": list(spec.train_labels),
           "val_labels": list(spec.val_labels), "test_labels": list(spec.test_labels),
           "db_json": spec.db_json, "moment_db_json": spec.moment_db_json}
    Path(path).write_text(json.dumps(doc))
    return str(path)


class TestLabels:
    def test_assets_are_byte_copies(self):
        src, dst = REPO / "vqwild_tpu/data/assets", REPO / "vqwild_tpu_torch/data/assets"
        names = sorted(p.name for p in src.glob("*.json"))
        assert names == sorted(p.name for p in dst.glob("*.json")) and len(names) == 2
        for n in names:
            assert filecmp.cmp(src / n, dst / n, shallow=False)

    @pytest.mark.parametrize("name", ["100_20_80", "120_20_60", "80_20_100", "40_20_140"])
    def test_registry_split_equals_jax(self, name):
        got, want = labels.get_split(name), jlabels.get_split(name)
        assert _as_dict(got) == _as_dict(want)
        for split in ("validation", "testing"):
            assert got.possible_classes(split) == want.possible_classes(split)
        assert got.cls2int() == want.cls2int() and got.all_labels == want.all_labels

    def test_constants_equal_jax(self):
        assert labels.ACTIVITYNET_LABELS == jlabels.ACTIVITYNET_LABELS
        assert labels.NOISE_LABEL == jlabels.NOISE_LABEL
        assert set(labels.split_registry()) == set(jlabels.split_registry())

    def test_load_split_file_and_get_split_by_path(self, tiny_arv, tmp_path):
        path = write_split_spec(tiny_arv, tmp_path / "spec.json")
        want = jlabels.load_split_file(path)
        assert _as_dict(labels.load_split_file(path)) == _as_dict(want)
        assert _as_dict(labels.get_split(path)) == _as_dict(tiny_arv["spec"])
        rel = tmp_path / "rel.json"
        rel.write_text(json.dumps({"name": "r", "train_labels": ["a"], "val_labels": [],
                                   "test_labels": ["b"], "db_json": "db.json"}))
        got = labels.load_split_file(str(rel))
        assert got.db_json == str(tmp_path / "db.json") and got.moment_db_json == ""
        assert _as_dict(got) == _as_dict(jlabels.load_split_file(str(rel)))

    def test_unknown_split_raises(self):
        with pytest.raises(KeyError, match="unknown meta split"):
            labels.get_split("nope")
        with pytest.raises(ValueError):
            labels.get_split("100_20_80").possible_classes("training")


class TestSchema:
    @pytest.mark.parametrize("split", SPLITS)
    def test_trimmed_db_flat_equals_jax(self, tiny_arv, split):
        got = schema.load_trimmed_db(tiny_arv["db_path"])
        want = jschema.load_trimmed_db(tiny_arv["db_path"])
        assert list(got.splits) == list(want.splits)
        assert list(got.splits[split]) == list(want.splits[split])  # label order
        g, w = got.flat(split), want.flat(split)
        assert len(g) == len(w) > 0
        assert [_as_dict(r) for r in g] == [_as_dict(r) for r in w]
        assert [r.duration_sec for r in g] == [r.duration_sec for r in w]

    def test_fewshot_and_cls2int_equal_jax(self, tiny_arv):
        got = schema.load_trimmed_db(tiny_arv["db_path"])
        want = jschema.load_trimmed_db(tiny_arv["db_path"])
        spec = labels.SplitSpec(**_as_dict(tiny_arv["spec"]))
        assert got.cls2int(spec, 5) == want.cls2int(tiny_arv["spec"], 5)
        few = got.training_for_fewshot(spec, 5)
        jfew = want.training_for_fewshot(tiny_arv["spec"], 5)
        assert {k: len(v) for k, v in few.items()} == {k: len(v) for k, v in jfew.items()}
        assert labels.NOISE_LABEL not in few

    def test_moment_db_equals_jax(self, tiny_arv):
        got = schema.load_moment_db(tiny_arv["moment_path"])
        want = jschema.load_moment_db(tiny_arv["moment_path"])
        assert [_as_dict(r) for r in got.query] == [_as_dict(r) for r in want.query]
        assert [_as_dict(r) for r in got.gallery] == [_as_dict(r) for r in want.gallery]
        assert len(got.nonnoise_queries()) == len(want.nonnoise_queries())

    def test_word_embeddings_equal_jax(self, tiny_arv):
        cls2int = {label: i for i, label in enumerate(tiny_arv["labels"])}
        args = (tiny_arv["embed_path"], cls2int, tiny_arv["nclass"])
        np.testing.assert_array_equal(schema.load_word_embeddings(*args),
                                      jschema.load_word_embeddings(*args))

    @pytest.mark.parametrize("name", ["wordembed_glove_d200.json", "x_d2000.json",
                                      "glove6Bd512.json", "d300/word2vec.json"])
    def test_semantic_dim_inference(self, name):
        assert schema.infer_semantic_dim(name) == jschema.infer_semantic_dim(name)


class TestSamplingAndTransforms:
    @pytest.mark.parametrize("segment", [(2.0, 12.0), (0.4, 0.9), (1.0, 14.0), (3.3, 3.4)])
    def test_segment_to_frames(self, segment):
        assert sampling.segment_to_frames(segment) == jsampling.segment_to_frames(segment)

    @pytest.mark.parametrize("args", [(10, 5, 8, 100), (0, 100, 4, 100), (95, 20, 4, 100),
                                      (3, 39, 32, 64), (0, 1, 3, 2)])
    def test_sample_frame_indices(self, args):
        got, want = sampling.sample_frame_indices(*args), jsampling.sample_frame_indices(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    def test_zero_frames_raises_and_helpers(self):
        with pytest.raises(ValueError):
            sampling.sample_frame_indices(0, 0, 4, 10)
        assert sampling.chunk_ranges(70, 32) == jsampling.chunk_ranges(70, 32)
        assert sampling.temporal_iou(0, 4, 2, 6) == jsampling.temporal_iou(0, 4, 2, 6)

    @pytest.mark.parametrize("hw", [(128, 171), (64, 64), (33, 40)])
    def test_crop_params(self, hw):
        size = 32
        assert transforms.center_crop_params(*hw, size) == _same(
            jtransforms.center_crop_params(*hw, size))
        a = transforms.random_crop_params(np.random.default_rng(5), *hw, size, flip_prob=0.5)
        b = jtransforms.random_crop_params(np.random.default_rng(5), *hw, size, flip_prob=0.5)
        assert _as_dict(a) == _as_dict(b)
        with pytest.raises(ValueError):
            transforms.random_crop_params(np.random.default_rng(0), 8, 8, 16)

    def test_apply_crop_normalize_resize(self):
        rng = np.random.default_rng(0)
        f = rng.integers(0, 256, (3, 20, 24, 3), dtype=np.uint8)
        p = transforms.CropParams(top=2, left=5, size=12, flip=True)
        jp = jtransforms.CropParams(top=2, left=5, size=12, flip=True)
        np.testing.assert_array_equal(transforms.apply_crop(f, p), jtransforms.apply_crop(f, jp))
        np.testing.assert_array_equal(transforms.normalize_imagenet(f),
                                      jtransforms.normalize_imagenet(f))
        x = transforms.normalize_imagenet(f)
        np.testing.assert_array_equal(transforms.denormalize_imagenet(x),
                                      jtransforms.denormalize_imagenet(x))
        np.testing.assert_array_equal(transforms.scaled_resize(f, 10),
                                      jtransforms.scaled_resize(f, 10))
        np.testing.assert_array_equal(transforms.IMAGENET_MEAN, jtransforms.IMAGENET_MEAN)
        np.testing.assert_array_equal(transforms.IMAGENET_STD, jtransforms.IMAGENET_STD)


def _same(jax_params):
    return transforms.CropParams(**_as_dict(jax_params))


IDX = np.array([1, 2, 7, 30, 64])


def _records(tiny_arv, split="validation", n=5):
    return (schema.load_trimmed_db(tiny_arv["db_path"]).flat(split)[:n],
            jschema.load_trimmed_db(tiny_arv["db_path"]).flat(split)[:n])


def _pack_rgb(store, root, vids, n=12):
    """A PackedFrameStore tree from ``store`` (the layout pack_from_jpeg writes)."""
    index, offset = {}, 0
    with open(root / "validation.bin", "wb") as blob:
        for vid in vids:
            fr = store.read_frames("validation", vid, np.arange(1, n + 1))
            blob.write(fr.tobytes())
            index[vid] = {"offset": offset, "n": n, "h": fr.shape[1], "w": fr.shape[2]}
            offset += n
    (root / "validation.json").write_text(json.dumps(index))


class _Short:
    """The first ``n`` frames of every video of a store."""

    def __init__(self, store, n):
        self.store, self.n = store, n

    def num_frames(self, subset, video_id):
        return self.n

    def read_frames(self, subset, video_id, indices):
        return self.store.read_frames(subset, video_id, indices)


class TestFrameStores:
    @pytest.mark.parametrize("vid", ["ev0001", "sc003_00001", "sn_00002", "sg004_00003"])
    def test_synthetic_stores_equal_jax(self, vid):
        for got, want in ((frames.SyntheticFrameStore(), jframes.SyntheticFrameStore()),
                          (frames.ClassSyntheticFrameStore(h=32, w=40),
                           jframes.ClassSyntheticFrameStore(h=32, w=40))):
            assert got.has_video("validation", vid)
            assert got.num_frames("validation", vid) == want.num_frames("validation", vid)
            a, b = (s.read_frames("validation", vid, IDX[:4]) for s in (got, want))
            assert a.dtype == np.uint8 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert frames.synth_video_frames(vid) == jframes.synth_video_frames(vid)
        assert frames.synth_schedule(vid, 5) == jframes.synth_schedule(vid, 5)

    def test_semantic_class_store_equals_jax(self, tmp_path):
        rng = np.random.default_rng(0)
        sem = {"loop": 4, "texture_amp": 30.0, "latents": rng.normal(size=(3, 2)).tolist(),
               "atoms": [{"fy": 0.1, "fx": 0.05, "vel": 1, "phase": [0.0, 1.0, 2.0]},
                         {"fy": 0.2, "fx": 0.15, "vel": 2, "phase": [0.5, 1.5, 2.5]}]}
        (tmp_path / "synth_semantics.json").write_text(json.dumps(sem))
        got = frames.make_frame_store("synthetic_class", str(tmp_path / "frames"))
        want = jframes.make_frame_store("synthetic_class", str(tmp_path / "frames"))
        assert got.semantics == want.semantics == sem and got.LOOP == 4
        np.testing.assert_array_equal(got.read_frames("training", "sc001_00007", IDX[:3]),
                                      want.read_frames("training", "sc001_00007", IDX[:3]))

    def test_packed_store_equals_jax(self, tmp_path):
        vids = ["ev0001", "ev0002"]
        _pack_rgb(frames.SyntheticFrameStore(h=16, w=21), tmp_path, vids)
        got, want = frames.PackedFrameStore(str(tmp_path)), jframes.PackedFrameStore(str(tmp_path))
        assert got.has_video("validation", "ev0002") and not got.has_video("validation", "zz")
        assert not got.has_video("training", "ev0001")  # no such subset on disk
        assert got.num_frames("validation", "ev0002") == 12
        idx = np.array([1, 5, 12])
        np.testing.assert_array_equal(got.read_frames("validation", "ev0002", idx),
                                      want.read_frames("validation", "ev0002", idx))
        np.testing.assert_array_equal(
            got.read_frames("validation", "ev0002", idx),
            frames.SyntheticFrameStore(h=16, w=21).read_frames("validation", "ev0002", idx))

    def test_packed_yuv_store_equals_jax(self, tmp_path):
        vids = {"validation": ["ev0001", "ev0002"]}
        a, b = tmp_path / "port", tmp_path / "jax"
        src = _Short(frames.SyntheticFrameStore(h=16, w=21), 10)  # odd width: padded
        frames.PackedYUV420FrameStore.pack_from_store(
            src, str(a), subsets=("validation",), video_ids=vids)
        jframes.PackedYUV420FrameStore.pack_from_store(
            src, str(b), subsets=("validation",), video_ids=vids)
        for name in ("validation.y.bin", "validation.uv.bin", "validation.json"):
            assert filecmp.cmp(a / name, b / name, shallow=False), name
        got = frames.PackedYUV420FrameStore(str(b))  # reads what the JAX package packed
        want = jframes.PackedYUV420FrameStore(str(a))
        assert got.supports_yuv and got.real_dims("validation") == (16, 21)
        idx = np.array([2, 9])
        for x, y in zip(got.read_frames_yuv("validation", "ev0002", idx),
                        want.read_frames_yuv("validation", "ev0002", idx)):
            np.testing.assert_array_equal(x, y)
        rgb = got.read_frames("validation", "ev0001", idx)
        assert rgb.shape == (2, 16, 21, 3)
        np.testing.assert_array_equal(rgb, want.read_frames("validation", "ev0001", idx))
        with pytest.raises(ValueError, match="video_ids or jpeg_root"):
            frames.PackedYUV420FrameStore.pack_from_store(src, str(a), subsets=("validation",))

    def test_jpeg_store_and_pack_from_jpeg(self, tmp_path):
        Image = pytest.importorskip("PIL.Image")
        d = tmp_path / "jpeg" / "validation" / "vidA"
        d.mkdir(parents=True)
        src = frames.SyntheticFrameStore(h=16, w=20)
        for i in range(1, 4):
            Image.fromarray(src.read_frames("validation", "vidA", [i])[0]).save(
                d / f"image_{i:05d}.jpg")
        got = frames.JpegDirFrameStore(str(tmp_path / "jpeg"))
        want = jframes.JpegDirFrameStore(str(tmp_path / "jpeg"))
        assert got.has_video("validation", "vidA") and not got.has_video("validation", "vidB")
        assert got.num_frames("validation", "vidA") == 3
        np.testing.assert_array_equal(got.read_frames("validation", "vidA", [1, 3]),
                                      want.read_frames("validation", "vidA", [1, 3]))
        frames.PackedFrameStore.pack_from_jpeg(str(tmp_path / "jpeg"), str(tmp_path / "packed"),
                                               subsets=("validation",))
        packed = frames.PackedFrameStore(str(tmp_path / "packed"))
        np.testing.assert_array_equal(packed.read_frames("validation", "vidA", [2]),
                                      got.read_frames("validation", "vidA", [2]))

    @pytest.mark.parametrize("kind,cls", [
        ("jpeg", "JpegDirFrameStore"), ("packed", "PackedFrameStore"),
        ("packed_yuv", "PackedYUV420FrameStore"), ("synthetic", "SyntheticFrameStore"),
        ("synthetic_class", "ClassSyntheticFrameStore")])
    def test_make_frame_store(self, kind, cls, tmp_path):
        assert type(frames.make_frame_store(kind, str(tmp_path))).__name__ == cls
        assert type(jframes.make_frame_store(kind, str(tmp_path))).__name__ == cls

    def test_make_frame_store_unknown_kind(self):
        with pytest.raises(ValueError, match="unknown frame store"):
            frames.make_frame_store("tape", "")

    def test_jpeg_store_imports_pil_lazily(self):
        import ast

        tree = ast.parse((REPO / "vqwild_tpu_torch/data/frames.py").read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert all("PIL" not in ast.dump(n) for n in top)


class TestClips:
    @pytest.mark.parametrize("seed", [None, 3])
    def test_read_clip_raw_and_batch(self, tiny_arv, seed):
        recs, jrecs = _records(tiny_arv)
        got = [clips.read_clip_raw(frames.SyntheticFrameStore(), r, 8, crop_size=64,
                                   rng=None if seed is None else np.random.default_rng(seed))
               for r in recs]
        want = [jclips.read_clip_raw(jframes.SyntheticFrameStore(), r, 8, crop_size=64,
                                     rng=None if seed is None else np.random.default_rng(seed))
                for r in jrecs]
        for a, b in zip(got, want):
            assert _as_dict(a.crop) == _as_dict(b.crop) and a.label == b.label
            np.testing.assert_array_equal(a.frames, b.frames)
        cropped = clips.batch_cropped_clips(got)
        assert cropped.shape == (5, 8, 64, 64, 3) and cropped.dtype == np.uint8
        np.testing.assert_array_equal(cropped, jclips.batch_cropped_clips(want))
        for a, b in zip(clips.batch_raw_clips(got), jclips.batch_raw_clips(want)):
            np.testing.assert_array_equal(a, b)

    def test_explicit_window_and_normalized(self, tiny_arv):
        recs, jrecs = _records(tiny_arv, n=1)
        kw = dict(crop_size=32, start_frame_idx=10, gt_frame_num=3)
        a = clips.read_clip_raw(frames.SyntheticFrameStore(), recs[0], 6, **kw)
        b = jclips.read_clip_raw(jframes.SyntheticFrameStore(), jrecs[0], 6, **kw)
        np.testing.assert_array_equal(a.frames, b.frames)
        np.testing.assert_array_equal(
            clips.read_clip_normalized(frames.SyntheticFrameStore(), recs[0], 4, crop_size=32),
            jclips.read_clip_normalized(jframes.SyntheticFrameStore(), jrecs[0], 4, crop_size=32))

    def test_read_clip_yuv_and_batch(self, tiny_arv, tmp_path):
        recs, jrecs = _records(tiny_arv, n=3)
        vids = {"validation": [r.video_id for r in recs]}
        src = _Short(frames.SyntheticFrameStore(h=40, w=51), 48)
        frames.PackedYUV420FrameStore.pack_from_store(
            src, str(tmp_path), subsets=("validation",), video_ids=vids)
        store, jstore = (m.PackedYUV420FrameStore(str(tmp_path)) for m in (frames, jframes))
        got = [clips.read_clip_yuv(store, r, 6, crop_size=32) for r in recs]
        want = [jclips.read_clip_yuv(jstore, r, 6, crop_size=32) for r in jrecs]
        for a, b in zip(got, want):
            assert _as_dict(a.crop) == _as_dict(b.crop)
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)
        y, uv = clips.batch_cropped_clips_yuv(got, 32)
        jy, juv = jclips.batch_cropped_clips_yuv(want, 32)
        assert y.shape == (3, 6, 32, 32) and uv.shape == (3, 6, 16, 16, 2)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(uv, juv)


class TestHostPreprocess:
    def _clips(self, shape=(3, 2, 20, 24, 3), seed=0):
        return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)

    def test_rgb_yuv_roundtrip_functions(self):
        f = self._clips()
        y, uv = pre.rgb_to_yuv420_host(f)
        jy, juv = jpre.rgb_to_yuv420_host(f)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(uv, juv)
        np.testing.assert_array_equal(pre.yuv420_to_rgb_host(y, uv),
                                      jpre.yuv420_to_rgb_host(y, uv))
        with pytest.raises(ValueError, match="even dims"):
            pre.rgb_to_yuv420_host(f[..., :19, :, :])

    @pytest.mark.parametrize("flip", [False, True])
    def test_crop_helpers(self, flip):
        f = self._clips(seed=1)
        y, uv = pre.rgb_to_yuv420_host(f)
        offsets = np.array([[0, 0], [3, 5], [8, 12]], np.int32)  # odd offsets round down
        flips = np.array([flip, not flip, flip])
        for a, b in zip(pre.crop_yuv420_host(y, uv, offsets, flips, 12),
                        jpre.crop_yuv420_host(y, uv, offsets, flips, 12)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pre.crop_clips_host(f, offsets, flips, 12),
                                      jpre.crop_clips_host(f, offsets, flips, 12))
        np.testing.assert_array_equal(pre.preprocess_host(f, offsets, flips, 12),
                                      jpre.preprocess_host(f, offsets, flips, 12))
        with pytest.raises(ValueError, match="must be even"):
            pre.crop_yuv420_host(y, uv, offsets, flips, 11)

    @pytest.mark.parametrize("flip", [False, True])
    def test_crop_yuv420_takes_each_clips_planes(self, flip):
        """A sequence of clips' planes crops as the stacked batch does (the
        loader's path: no stacked copy of the whole frames)."""
        y, uv = pre.rgb_to_yuv420_host(self._clips(seed=2))
        offsets = np.array([[2, 4], [7, 1], [8, 12]], np.int32)
        flips = np.array([flip, not flip, flip])
        for a, b in zip(pre.crop_yuv420_host(list(y), list(uv), offsets, flips, 12),
                        jpre.crop_yuv420_host(y, uv, offsets, flips, 12)):
            np.testing.assert_array_equal(a, b)

    def test_device_normalize_matches_host_preprocess(self):
        import torch

        f = self._clips(seed=2)
        offsets, flips = np.zeros((3, 2), np.int32), np.zeros(3, bool)
        want = pre.preprocess_host(f, offsets, flips, 20)
        got = pre.normalize_clips(torch.from_numpy(pre.crop_clips_host(f, offsets, flips, 20)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


class TestSmallHostModules:
    def test_multi_query_lists_equal_jax(self):
        queries = [{"label": "ab"[i % 2], "vid": f"v{i // 3}"} for i in range(14)]
        kw = dict(label_of=lambda q: q["label"], video_id_of=lambda q: q["vid"])
        got = multiquery.generate_multi_query(queries, **kw)
        assert got == jmultiquery.generate_multi_query(queries, **kw)
        assert all(len(qs) == 5 for qs in got)
        assert multiquery.generate_multi_query(queries[:1], **kw) == [[queries[0]]]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_metrics_np_equal_jax(self, seed):
        rng = np.random.default_rng(seed)
        scores = rng.integers(0, 9, 40).astype(np.float64)
        tp, ignore = rng.random(40) < 0.25, rng.random(40) < 0.1
        assert metrics_np.average_precision(tp, scores) == jmetrics_np.average_precision(tp, scores)
        for robust in (True, False):
            assert metrics_np.single_query_metrics(scores, tp, ignore, (5, 10), robust) == \
                jmetrics_np.single_query_metrics(scores, tp, ignore, (5, 10), robust)
        assert metrics_np.average_precision(np.zeros(4), np.arange(4.0)) == 0.0

    def test_hostmem_alloc_array(self):
        a = hostmem.alloc_array((3, 5), np.float32)
        b = jhostmem.alloc_array((3, 5), np.float32)
        assert a.shape == b.shape == (3, 5) and a.dtype == b.dtype == np.float32
        a[...] = 1.0
        assert float(a.sum()) == 15.0

    def test_meters_equal_jax(self):
        got, want = meters.AverageMeter(), jmeters.AverageMeter()
        for m in (got, want):
            m.update(2.0, 3)
            m.update(4.0)
        assert (got.val, got.avg, got.sum, got.count) == (want.val, want.avg, want.sum, want.count)

    def test_config_defaults_equal_jax(self):
        got, want = config.ExperimentConfig(), jconfig.ExperimentConfig()
        got_d = _as_dict(got)
        # the port's own field, which the JAX config has not
        assert got_d["model"].pop("trunk") == "resnet18_f2f"
        assert got_d == _as_dict(want)
        assert got.data.frame_hw == want.data.frame_hw == (128, 171)

    def test_phase_accumulates_wall_time(self):
        timings = {}
        for _ in range(2):
            with phase(timings, "a"):
                time.sleep(0.01)
        with pytest.raises(RuntimeError):
            with phase(timings, "b"):
                raise RuntimeError("boom")
        assert timings["a"] >= 0.02 and 0.0 <= timings["b"] < timings["a"]


class TestDataStack:
    def test_resolve_data_file(self, tmp_path):
        (tmp_path / "data_generate").mkdir()
        (tmp_path / "data_generate" / "arv_db_x.json").write_text("{}")
        (tmp_path / "top.json").write_text("{}")
        assert cli.resolve_data_file("top.json", str(tmp_path)) == str(tmp_path / "top.json")
        assert cli.resolve_data_file("arv_db_x.json", str(tmp_path)) == str(
            tmp_path / "data_generate" / "arv_db_x.json")
        assert cli.resolve_data_file(str(tmp_path / "top.json"), "elsewhere") == str(
            tmp_path / "top.json")
        with pytest.raises(FileNotFoundError, match="not found under"):
            cli.resolve_data_file("missing.json", str(tmp_path))

    def test_build_data_stack_from_a_split_file(self, tiny_arv, tmp_path):
        path = write_split_spec(tiny_arv, tmp_path / "spec.json")
        cfg = config.ExperimentConfig(
            data=config.DataConfig(meta_split=path, frame_store="synthetic"))
        spec, db, store = cli.build_data_stack(cfg)
        assert spec.name == "tiny" and isinstance(store, frames.SyntheticFrameStore)
        assert len(db.flat("testing")) == len(
            jschema.load_trimmed_db(tiny_arv["db_path"]).flat("testing"))
