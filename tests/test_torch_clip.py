"""Port's untrimmed clip regime (vqwild_tpu_torch/data/longvideo.py,
ops/segment_pool.py, FeatureExtractor.extract_video_tapes,
retrieval/clip.py and ``serve --regime clip``) against the JAX package's
on the CPU, on the tiny ARV dataset's moment DB with the synthetic frame
store: chunks and chunk batches equal, pooled windows within 1e-5 (torch)
or equal (host copies), tapes equal from fake features and within 1e-4
from the same weights, the metric dict within 1e-6, the server-built clip
index's meta.json equal to the JAX server's.

The JAX package is imported inside the ``jx`` fixture, not at the top, so
that the ``cuda`` test at the end runs on a machine that has only the port
(``python -m pytest --noconftest -m cuda tests/test_torch_clip.py``).
"""

import argparse
import dataclasses
import json
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.data import longvideo
from vqwild_tpu_torch.data.frames import PackedYUV420FrameStore, SyntheticFrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import Annotation, load_moment_db
from vqwild_tpu_torch.ops import ranking, segment_pool
from vqwild_tpu_torch.retrieval import (
    ARVRetrievalClip,
    FeatureExtractor,
    make_fake_feat_fn,
    make_feat_fn,
)
from vqwild_tpu_torch.retrieval.clip import window_label

R_AT_N = (5, 10, 30)
FAKE_TOL = 1e-6  # same features: only the order of the metric sums differs
E2E_TOL = 1e-4  # features from two frameworks' convs


@pytest.fixture(scope="module")
def jx():
    """The JAX package's counterparts of what this file tests."""
    import jax.numpy as jnp

    from vqwild_tpu.data import longvideo as jlongvideo
    from vqwild_tpu.data.frames import PackedYUV420FrameStore as JaxPackedYUV
    from vqwild_tpu.data.frames import SyntheticFrameStore as JaxSyntheticFrameStore
    from vqwild_tpu.data.schema import Annotation as JaxAnnotation
    from vqwild_tpu.data.schema import load_moment_db as jax_load_moment_db
    from vqwild_tpu.ops import segment_pool as jsegment_pool
    from vqwild_tpu.retrieval import clip as jclip
    from vqwild_tpu.retrieval.features import FeatureExtractor as JaxFeatureExtractor
    from vqwild_tpu.retrieval.features import make_fake_feat_fn as jax_make_fake_feat_fn
    from vqwild_tpu.retrieval.features import make_feat_fn as jax_make_feat_fn
    from vqwild_tpu.serve import __main__ as jserve

    from tests.test_torch_trimmed import assert_close_tree

    return SimpleNamespace(
        jnp=jnp, longvideo=jlongvideo, PackedYUV=JaxPackedYUV, Store=JaxSyntheticFrameStore,
        Annotation=JaxAnnotation, load_moment_db=jax_load_moment_db,
        segment_pool=jsegment_pool, clip=jclip, Extractor=JaxFeatureExtractor,
        make_fake_feat_fn=jax_make_fake_feat_fn, make_feat_fn=jax_make_feat_fn, serve=jserve,
        assert_close_tree=assert_close_tree)


@pytest.fixture(scope="module")
def weights(jx):
    from tests.test_torch_trunk import full_model_variables, random_trunk_variables
    from vqwild_tpu_torch.models.convert import state_dict_from_jax, trunk_from_state_dict

    v = full_model_variables(random_trunk_variables(seed=12))
    return SimpleNamespace(vars=v, trunk=trunk_from_state_dict(state_dict_from_jax(v)),
                           jmodel=SimpleNamespace(dtype=jx.jnp.float32, bn_eps=1e-3))


def _spec(tiny_arv):
    return SplitSpec(**dataclasses.asdict(tiny_arv["spec"]))


def _galleries(tiny_arv, jx):
    return (load_moment_db(tiny_arv["moment_path"]).gallery,
            jx.load_moment_db(tiny_arv["moment_path"]).gallery)


def _fake(jx, seed=0, **kw):
    args = dict(test_frames=8, test_batch_size=4, fake=True)
    args.update(kw)
    return (FeatureExtractor(make_fake_feat_fn(32, seed=seed), SyntheticFrameStore(), **args),
            jx.Extractor(jx.make_fake_feat_fn(32, seed=seed), jx.Store(), **args))


def _real(jx, weights, wire, store=None, jstore=None, **kw):
    args = dict(test_frames=16, test_batch_size=4, input_size=32, wire=wire)
    args.update(kw)
    return (FeatureExtractor(make_feat_fn(weights.trunk, wire=wire, device="cpu"),
                             store or SyntheticFrameStore(), **args),
            jx.Extractor(jx.make_feat_fn(weights.jmodel, weights.vars, wire=wire),
                         jstore or jx.Store(), **args))


def _pack_yuv(gallery, root):
    PackedYUV420FrameStore.pack_from_store(
        SyntheticFrameStore(h=40, w=52), str(root), subsets=("validation",),
        video_ids={"validation": [r.video_id for r in gallery]})


def _assert_tapes(got, want, tol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


class TestLongVideo:
    @pytest.mark.parametrize("test_frames", [8, 30, 64, 100])
    def test_enumerate_chunks_equal_jax(self, tiny_arv, jx, test_frames):
        gallery, jgallery = _galleries(tiny_arv, jx)
        got = longvideo.enumerate_chunks(gallery, SyntheticFrameStore(), test_frames)
        want = jx.longvideo.enumerate_chunks(jgallery, jx.Store(), test_frames)
        assert len(got) == len(want) == len(gallery) * -(-64 // test_frames)
        assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]

    def test_read_chunk_batch_equal_jax(self, tiny_arv, jx):
        """Full and partial chunks (64 frames = 30 + 30 + 4), CenterCrop."""
        gallery, jgallery = _galleries(tiny_arv, jx)
        refs = longvideo.enumerate_chunks(gallery[:2], SyntheticFrameStore(), 30)
        jrefs = jx.longvideo.enumerate_chunks(jgallery[:2], jx.Store(), 30)
        got = longvideo.read_chunk_batch(refs, gallery, SyntheticFrameStore(), 30, crop_size=32)
        want = jx.longvideo.read_chunk_batch(jrefs, jgallery, jx.Store(), 30, crop_size=32)
        assert got.shape == (6, 30, 32, 32, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)

    def test_read_chunk_batch_yuv_equal_jax(self, tiny_arv, jx, tmp_path):
        gallery, jgallery = _galleries(tiny_arv, jx)
        _pack_yuv(gallery[:3], tmp_path)
        refs = longvideo.enumerate_chunks(gallery[:3], PackedYUV420FrameStore(str(tmp_path)), 30)
        jrefs = jx.longvideo.enumerate_chunks(jgallery[:3], jx.PackedYUV(str(tmp_path)), 30)
        got = longvideo.read_chunk_batch_yuv(refs, gallery, PackedYUV420FrameStore(str(tmp_path)),
                                             30, crop_size=32)
        want = jx.longvideo.read_chunk_batch_yuv(jrefs, jgallery, jx.PackedYUV(str(tmp_path)),
                                                 30, crop_size=32)
        assert got[0].shape == (9, 30, 32, 32) and got[1].shape == (9, 30, 16, 16, 2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_concat_video_tapes_equal_jax(self, tiny_arv, jx):
        """Chunks in shuffled order are put back by seg_id; a video without
        chunks gets a [0, 0] tape."""
        gallery, jgallery = _galleries(tiny_arv, jx)
        refs = longvideo.enumerate_chunks(gallery[:3], SyntheticFrameStore(), 30)
        jrefs = jx.longvideo.enumerate_chunks(jgallery[:3], jx.Store(), 30)
        order = np.random.default_rng(0).permutation(len(refs))
        feats = np.random.default_rng(1).random((len(refs), 5, 30), dtype=np.float32)
        got = longvideo.concat_video_tapes(feats, [refs[i] for i in order], 4)
        want = jx.longvideo.concat_video_tapes(feats, [jrefs[i] for i in order], 4)
        _assert_tapes(got, want)
        assert got[0].shape == (5, 90) and got[3].shape == (0, 0)


class TestSegmentPool:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sliding_window_mean_matches_jax(self, jx, seed):
        rng = np.random.default_rng(seed)
        t, c, w = 50 + 17 * seed, 8, 12
        tape = rng.normal(size=(t, c)).astype(np.float32)
        starts = rng.integers(0, t - 1, w).astype(np.int32)
        ends = (starts + rng.integers(1, t - starts + 1)).astype(np.int32)
        starts[0], ends[0] = 0, t  # the whole tape
        got = segment_pool.sliding_window_mean(torch.from_numpy(tape), torch.from_numpy(starts),
                                               torch.from_numpy(ends)).numpy()
        want = np.asarray(jx.segment_pool.sliding_window_mean(
            jx.jnp.asarray(tape), jx.jnp.asarray(starts), jx.jnp.asarray(ends)))
        assert got.shape == (w, c) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        for k, (a, b) in enumerate(zip(starts, ends)):
            np.testing.assert_allclose(got[k], tape[a:b].mean(0), atol=1e-5)

    def test_window_mean_from_cumsum_matches_jax(self, jx):
        rng = np.random.default_rng(3)
        cum = np.concatenate([np.zeros((1, 4)), np.cumsum(rng.normal(size=(20, 4)), 0)])
        cum = cum.astype(np.float32)
        starts, ends = np.array([0, 3, 7, 19], np.int32), np.array([20, 4, 15, 20], np.int32)
        got = segment_pool.window_mean_from_cumsum(
            torch.from_numpy(cum), torch.from_numpy(starts), torch.from_numpy(ends)).numpy()
        want = np.asarray(jx.segment_pool.window_mean_from_cumsum(
            jx.jnp.asarray(cum), jx.jnp.asarray(starts), jx.jnp.asarray(ends)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_window_mean_np_equal_jax(self, jx):
        rng = np.random.default_rng(4)
        tape = rng.normal(size=(40, 6)).astype(np.float32)
        starts, ends = np.array([0, 5, 12, 39]), np.array([18, 6, 40, 40])
        got = segment_pool.window_mean_np(tape, starts, ends)
        np.testing.assert_array_equal(got, jx.segment_pool.window_mean_np(tape, starts, ends))
        assert got.dtype == np.float32

    def test_host_window_pooler_equal_jax(self, jx):
        """One pooler over tapes that grow and shrink (its scratch is reused
        and regrown), written into views of one output block."""
        rng = np.random.default_rng(5)
        pooler, jpooler = segment_pool.HostWindowPooler(), jx.segment_pool.HostWindowPooler()
        for c, t, w in [(4, 10, 3), (8, 64, 9), (4, 30, 2), (16, 200, 40)]:
            tape = rng.normal(size=(c, t)).astype(np.float32)
            starts = rng.integers(0, t - 1, w)
            ends = starts + rng.integers(1, t - starts + 1)
            out, jout = np.zeros((w + 2, c), np.float32), np.zeros((w + 2, c), np.float32)
            pooler(tape, starts, ends, out=out[1 : w + 1])
            jpooler(tape, starts, ends, out=jout[1 : w + 1])
            np.testing.assert_array_equal(out, jout)
            np.testing.assert_allclose(out[1 : w + 1],
                                       segment_pool.window_mean_np(tape.T, starts, ends),
                                       rtol=0, atol=1e-6)

    @pytest.mark.parametrize("args", [(20.0, 60, 6, 3, 1), (64 / 3, 64, 6, 3, 1),
                                      (125.7, 380, 6, 3, 2), (5.0, 15, 6, 3, 1)])
    def test_enumerate_clip_windows_equal_jax(self, jx, args):
        got = segment_pool.enumerate_clip_windows(*args)
        want = jx.segment_pool.enumerate_clip_windows(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        if args[0] == 20.0:  # the windows tests/test_ops.py holds
            assert got[0].tolist() == [0, 18, 36] and got[1].tolist() == [18, 36, 54]

    @pytest.mark.parametrize("args", [(20.0, 60, 5, 3, 3, 1), (64 / 3, 64, 5, 4, 3, 1),
                                      (130.2, 400, 5, 26, 3, 1)])
    def test_enumerate_moment_windows_equal_jax(self, jx, args):
        got = segment_pool.enumerate_moment_windows(*args)
        want = jx.segment_pool.enumerate_moment_windows(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        if args[0] == 20.0:
            # upstream's range bound excludes a start at duration - length
            assert got[2].tolist() == [[0, 5], [5, 10], [10, 15], [0, 10], [5, 15], [0, 15]]


class TestVideoTapes:
    def test_fake_tapes_equal_jax(self, tiny_arv, jx):
        gallery, jgallery = _galleries(tiny_arv, jx)
        ex, jex = _fake(jx)
        got, want = ex.extract_video_tapes(gallery), jex.extract_video_tapes(jgallery)
        _assert_tapes(got, want)
        assert len(got) == 16 and got[0].shape == (32, 64)
        # one arena: every tape is a view into the same block
        assert all(t.base is got[0].base for t in got)

    @pytest.mark.parametrize("wire", ["rgb", "yuv420"])
    def test_tapes_from_same_weights(self, tiny_arv, jx, weights, wire):
        gallery, jgallery = _galleries(tiny_arv, jx)
        ex, jex = _real(jx, weights, wire)
        got, want = ex.extract_video_tapes(gallery[:2]), jex.extract_video_tapes(jgallery[:2])
        assert got[0].shape == (512, 64)
        _assert_tapes(got, want, E2E_TOL)
        # unit-norm frame embeddings
        np.testing.assert_allclose(np.linalg.norm(got[1], axis=0), 1.0, atol=1e-5)

    @pytest.mark.parametrize("max_batches", [0, 1, 5])
    def test_max_batches_cap(self, tiny_arv, jx, max_batches):
        """The debug cap: chunks past the cap are not read, their videos'
        tapes are cut short or empty."""
        gallery, jgallery = _galleries(tiny_arv, jx)
        ex, jex = _fake(jx, max_batches=max_batches)
        got, want = ex.extract_video_tapes(gallery), jex.extract_video_tapes(jgallery)
        _assert_tapes(got, want)
        kept = sum(t.shape[1] for t in got) // 8
        assert kept == min(4 * max_batches, 16 * 8)
        assert got[-1].size == 0

    def test_yuv_native_store(self, tiny_arv, jx, weights, tmp_path):
        gallery, jgallery = _galleries(tiny_arv, jx)
        _pack_yuv(gallery[:2], tmp_path)
        ex, jex = _real(jx, weights, "yuv420", PackedYUV420FrameStore(str(tmp_path)),
                        jx.PackedYUV(str(tmp_path)), test_frames=24)
        assert ex.yuv_native and jex.yuv_native
        got, want = ex.extract_video_tapes(gallery[:2]), jex.extract_video_tapes(jgallery[:2])
        assert got[0].shape == (512, 72)  # 64 frames in chunks of 24: the last one padded
        _assert_tapes(got, want, E2E_TOL)

    def test_one_embed_call_per_batch(self, tiny_arv):
        """6 chunks per video in batches of 4: the trunk sees 4 batches of
        one shape, the last padded to 4 rows."""
        gallery = load_moment_db(tiny_arv["moment_path"]).gallery[:2]
        shapes = []
        fake = make_fake_feat_fn(16, seed=1)

        def spy(x):
            shapes.append(x.shape)
            return fake(x)

        ex = FeatureExtractor(spy, SyntheticFrameStore(), test_frames=12, test_batch_size=4,
                              fake=True)
        tapes = ex.extract_video_tapes(gallery)
        assert [s[0] for s in shapes] == [4, 4, 4]  # fake features skip the row padding
        assert [t.shape for t in tapes] == [(16, 72), (16, 72)]


class TestWindowLabel:
    @pytest.mark.parametrize("loc,classes,want", [
        ((3.0, 9.0), {"x", "y"}, "y"),
        ((0.0, 4.0), {"x", "y"}, "x"),  # the first annotation that covers it
        ((3.0, 9.0), {"y"}, "y"),
        ((10.0, 25.0), {"x", "y"}, "unknown"),
    ])
    def test_equal_jax(self, jx, loc, classes, want):
        anns = [Annotation(segment=(0.0, 5.0), label="x"),
                Annotation(segment=(2.0, 20.0), label="y")]
        janns = [jx.Annotation(segment=(0.0, 5.0), label="x"),
                 jx.Annotation(segment=(2.0, 20.0), label="y")]
        assert window_label(anns, loc, classes) == jx.clip.window_label(janns, loc, classes) == want


def _evaluators(tiny_arv, jx, ex, jex, **kw):
    args = dict(clip_sec=6, r_at_n=R_AT_N, rank_chunk=7)
    args.update(kw)
    ev = ARVRetrievalClip(load_moment_db(tiny_arv["moment_path"]), _spec(tiny_arv), ex,
                          device="cpu", **args)
    jev = jx.clip.ARVRetrievalClip(jx.load_moment_db(tiny_arv["moment_path"]), tiny_arv["spec"],
                                   jex, **args)
    return ev, jev


class TestClipEval:
    @pytest.mark.parametrize("rank_chunk", [7, 256])
    @pytest.mark.parametrize("query_num", [1, 2])
    def test_metric_dict_matches_jax(self, tiny_arv, jx, query_num, rank_chunk):
        ev, jev = _evaluators(tiny_arv, jx, *_fake(jx), query_num=query_num,
                              rank_chunk=rank_chunk)
        got, want = ev.evaluation(), jev.evaluation()
        jx.assert_close_tree(got, want, FAKE_TOL)
        assert 0.0 < got["ap"] < 1.0 and set(got["recall"]) == {"5", "10", "30"}

    def test_cm_dict_matches_jax(self, tiny_arv, jx):
        ev, jev = _evaluators(tiny_arv, jx, *_fake(jx), collect_diagnostics=True)
        got, want = ev.evaluation(), jev.evaluation()
        items = got["cm_dict"]["top30_result_list"]
        assert items and set(items[0][0]) == {"video_id", "clip_label", "loc"}
        # the y_pred streams are raw scores from two frameworks' fp32
        # matmuls: 2e-5; all else 1e-6
        streams = [{k: d["cm_dict"]["system_ap_dict"].pop(k)
                    for k in list(d["cm_dict"]["system_ap_dict"]) if k.endswith("y_pred")}
                   for d in (got, want)]
        assert streams[0]
        jx.assert_close_tree(streams[0], streams[1], 2e-5)
        jx.assert_close_tree(got, want, FAKE_TOL)
        plain, _ = _evaluators(tiny_arv, jx, *_fake(jx))
        # the per-chunk path and the whole-eval path give the same metrics
        jx.assert_close_tree({k: v for k, v in got.items() if k != "cm_dict"},
                          plain.evaluation(), FAKE_TOL)

    def test_read_cache_roundtrip(self, tiny_arv, jx, tmp_path):
        """The gallery cache the port writes, read back by the port and by
        the JAX package, gives identical results; another seed's features
        could not."""
        ex, jex = _fake(jx, cache_dir=str(tmp_path))
        ev, _ = _evaluators(tiny_arv, jx, ex, jex)
        first = ev.evaluation()
        assert (tmp_path / "clip_gallery" / "locs.npy").exists()
        ex2, jex2 = _fake(jx, cache_dir=str(tmp_path))
        ev2, jev2 = _evaluators(tiny_arv, jx, ex2, jex2, read_cache=True)
        again = ev2.evaluation()
        assert again == first
        jx.assert_close_tree(jev2.evaluation(), first, FAKE_TOL)
        # another seed's extractor reading the cache gets the first run's
        # gallery, not its own
        ex3, _ = _fake(jx, seed=99, cache_dir=str(tmp_path))
        ev3, _ = _evaluators(tiny_arv, jx, ex3, jex2, read_cache=True)
        feats, labels, vidx, locs = ev3.build_gallery()
        cache = {k: np.load(tmp_path / "clip_gallery" / f"{k}.npy")
                 for k in ("feats", "labels", "video_idx", "locs")}
        assert feats.shape == (48, 32) and labels.tolist() == cache["labels"].tolist()
        for got, k in ((feats, "feats"), (vidx, "video_idx"), (locs, "locs")):
            np.testing.assert_array_equal(got, cache[k])

    def test_timings_have_no_compile_phase(self, tiny_arv, jx):
        ev, _ = _evaluators(tiny_arv, jx, *_fake(jx))
        ev.evaluation()
        assert set(ev.timings) == {"query_feats", "gallery_build", "gallery_to_device",
                                   "rank_dispatch", "metrics_readback"}
        assert all(v >= 0.0 for v in ev.timings.values())

    def test_each_chunk_is_scored_once_from_the_query_bank(self, tiny_arv, jx, monkeypatch):
        calls = []
        real = ranking.gather_scores

        def spy(q_bank, gallery, q_rows):
            calls.append((tuple(q_bank.shape), tuple(gallery.shape), tuple(q_rows.shape)))
            return real(q_bank, gallery, q_rows)

        monkeypatch.setattr(ranking, "gather_scores", spy)
        ev, _ = _evaluators(tiny_arv, jx, *_fake(jx), rank_chunk=7)
        ev.evaluation()
        # 18 queries of the train + test classes; 48 windows of 6 s
        assert calls == [((18, 32), (48, 32), (7, 1))] * 3


class TestServeClip:
    def test_clip_index_matches_jax_server(self, tiny_arv, jx, weights, tmp_path):
        """No index on disk: ``--regime clip`` builds the clip index of the
        moment DB's gallery videos, saves and serves it; a feature query for
        a row answers that row first with its loc_sec. meta.json equals the
        JAX server's clip index, feats.npy is within 1e-4 of it."""
        from tests.test_torch_data import write_split_spec
        from tests.test_torch_serve import _serve_in_thread
        from vqwild_tpu.models import torch_export

        ckpt = str(tmp_path / "best.pth.tar")
        torch_export.save_reference_checkpoint(ckpt, weights.vars, "baseline")
        spec_path = write_split_spec(tiny_arv, tmp_path / "spec.json")
        flags = dict(meta_split=spec_path, frame_store="synthetic", max_gallery=4,
                     input_size=32, test_frame=16, test_batch_size=4, clip_sec=6)
        argv = ["--index_dir", str(tmp_path / "idx"), "--test_load", ckpt, "--port", "0",
                "--device", "cpu", "--max_wait_ms", "1", "--regime", "clip"]
        for k, v in flags.items():
            argv += [f"--{k}", str(v)]
        srv, thread = _serve_in_thread(argv)
        try:
            feats = np.load(tmp_path / "idx" / "feats.npy")
            meta = json.loads((tmp_path / "idx" / "meta.json").read_text())
            url = f"http://127.0.0.1:{srv.server_address[1]}/query/features"
            for row in (0, 4, 11):
                body = json.dumps({"feature": feats[row].tolist(), "k": 3}).encode()
                with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                            timeout=60) as r:
                    res = json.load(r)["results"]
                assert res[0]["rank"] == 0 and res[0]["video_id"] == meta[row]["video_id"]
                assert res[0]["loc_sec"] == meta[row]["loc_sec"]
        finally:
            srv.shutdown()
            thread.join(timeout=30)
        assert not thread.is_alive()

        args = argparse.Namespace(data_root=str(tmp_path), frames_dir="", method="baseline",
                                  eval_split="testing", trunk_int8=False, regime="clip",
                                  **flags)
        jidx = jx.serve._build_index(args, jx.make_feat_fn(weights.jmodel, weights.vars,
                                                           wire="yuv420"))
        jidx.save(str(tmp_path / "jidx"))
        assert feats.shape == (12, 512) and len(meta) == 12  # 4 videos x 3 windows of 6 s
        assert set(meta[0]) == {"video_id", "label", "loc_sec"}
        assert meta == json.loads((tmp_path / "jidx" / "meta.json").read_text())
        np.testing.assert_allclose(feats, np.load(tmp_path / "jidx" / "feats.npy"),
                                   rtol=0, atol=E2E_TOL)


class TestDeviceRule:
    def test_cuda_default_raises_without_gpu(self, tiny_arv):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        ex = FeatureExtractor(make_fake_feat_fn(8, seed=0), SyntheticFrameStore(),
                              test_frames=8, fake=True)
        with pytest.raises(RuntimeError, match="cuda"):
            ARVRetrievalClip(load_moment_db(tiny_arv["moment_path"]), _spec(tiny_arv), ex)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    def test_clip_metrics_match_cpu(self, cuda, tmp_path):
        """The clip evaluator on the card (K1 scores each chunk) against the
        same evaluation on the CPU, on seeded fake features over a seeded
        moment DB of 300 videos (~6,000 windows): every metric within 1e-3,
        the rule ``chip_smoke.py`` holds the card to."""
        from chip_smoke import length_store, tree_max_diff, write_moment_db
        from vqwild_tpu_torch.data.labels import get_split
        from vqwild_tpu_torch.ops import distance

        spec_path, frames = write_moment_db(str(tmp_path), videos=300, queries=600, labels=30,
                                            seed=3)
        spec = get_split(spec_path)
        mdb = load_moment_db(spec.moment_db_json)

        def run(device):
            ex = FeatureExtractor(make_fake_feat_fn(512, seed=4), length_store(frames),
                                  test_frames=32, test_batch_size=30, fake=True)
            return ARVRetrievalClip(mdb, spec, ex, device=device).evaluation()

        before = distance.launches.n
        got = run(cuda)
        assert distance.launches.n == before + 3  # 600 queries: 3 chunks of 256
        assert tree_max_diff(got, run("cpu")) <= 1e-3
