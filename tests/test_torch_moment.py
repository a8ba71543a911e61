"""Port's untrimmed moment regime (vqwild_tpu_torch/ops/nms.py, native/,
retrieval/moment.py, serve/index.MomentIndex, QueryService.query_moments and
``serve --regime moment``) against the JAX package's on the CPU, on the tiny
ARV dataset's moment DB with the synthetic frame store: NMS keep lists,
closest hits, pooled windows and MomentIndex rows equal; the port's native
engine within 1e-12 of JAX's numpy postprocess; the metric dict within 1e-6
of JAX's host path for both of the port's engines.

Every call into the JAX moment code runs with the JAX native engine patched
unavailable (``vqwild_tpu.native.lib.available``), so JAX takes its numpy
path, never builds or loads its own library, and leaves nothing set for the
other tests of the process. The JAX package is imported inside fixtures,
not at the top, so that the ``cuda`` test at the end runs on a machine that
has only the port (``python -m pytest --noconftest -m cuda
tests/test_torch_moment.py``).
"""

import dataclasses
import json
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import Annotation, load_moment_db
from vqwild_tpu_torch.native import lib as native_lib
from vqwild_tpu_torch.ops import distance, nms
from vqwild_tpu_torch.retrieval import ARVRetrievalMoment, FeatureExtractor, make_fake_feat_fn
from vqwild_tpu_torch.retrieval import moment
from vqwild_tpu_torch.serve.http import make_server
from vqwild_tpu_torch.serve.index import GalleryIndex, MomentIndex
from vqwild_tpu_torch.serve.service import QueryService

R_AT_N = (5, 10, 30)
FAKE_TOL = 1e-6  # same features: only the scores' last bits and sum orders differ
# a bf16 readback rounds scores to 8 bits of mantissa: rank flips among
# near-tied moments (the JAX test holds its bf16 path to the same bounds)
BF16_AP_TOL, BF16_RECALL_TOL = 5e-3, 2e-2


@pytest.fixture(scope="module")
def jx():
    """The JAX package's counterparts of what this file tests."""
    from vqwild_tpu.data.frames import SyntheticFrameStore as JaxSyntheticFrameStore
    from vqwild_tpu.data.schema import Annotation as JaxAnnotation
    from vqwild_tpu.data.schema import load_moment_db as jax_load_moment_db
    from vqwild_tpu.native import lib as jax_native_lib
    from vqwild_tpu.ops import nms as jnms
    from vqwild_tpu.retrieval import moment as jmoment
    from vqwild_tpu.retrieval.features import FeatureExtractor as JaxFeatureExtractor
    from vqwild_tpu.retrieval.features import make_fake_feat_fn as jax_make_fake_feat_fn
    from vqwild_tpu.serve import __main__ as jserve
    from vqwild_tpu.serve.index import MomentIndex as JaxMomentIndex

    from tests.test_torch_trimmed import assert_close_tree

    return SimpleNamespace(
        Store=JaxSyntheticFrameStore, Annotation=JaxAnnotation,
        load_moment_db=jax_load_moment_db, native_lib=jax_native_lib, nms=jnms,
        moment=jmoment, Extractor=JaxFeatureExtractor,
        make_fake_feat_fn=jax_make_fake_feat_fn, serve=jserve, MomentIndex=JaxMomentIndex,
        assert_close_tree=assert_close_tree)


@pytest.fixture(autouse=True)
def _jax_native_off(request, monkeypatch):
    """JAX's moment code on its numpy path; its native lib never loads."""
    if request.node.get_closest_marker("cuda") is None:
        jax_native_lib = request.getfixturevalue("jx").native_lib
        monkeypatch.setattr(jax_native_lib, "available", lambda: False)


def _spec(tiny_arv):
    return SplitSpec(**dataclasses.asdict(tiny_arv["spec"]))


def _fake(jx, seed=0, **kw):
    args = dict(test_frames=8, test_batch_size=4, fake=True)
    args.update(kw)
    return (FeatureExtractor(make_fake_feat_fn(32, seed=seed), SyntheticFrameStore(), **args),
            jx.Extractor(jx.make_fake_feat_fn(32, seed=seed), jx.Store(), **args))


@pytest.fixture(scope="module")
def ignoring_db(tiny_arv, tmp_path_factory):
    """The tiny moment DB with six queries moved into gallery videos, so
    that the multi-query ignore set removes gallery moments."""
    doc = json.loads(open(tiny_arv["moment_path"]).read())
    for qi, gi in zip(range(0, 24, 4), range(0, 16, 3)):
        doc["query"][qi]["video_id"] = doc["gallery"][gi]["video_id"]
    path = tmp_path_factory.mktemp("moment_db") / "arv_db_tiny_untrimmed.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _evaluators(tiny_arv, jx, ex, jex, db_path=None, **kw):
    args = dict(moment_clip_sec=5, r_at_n=R_AT_N, rank_chunk=7, workers=3)
    args.update(kw)
    db_path = db_path or tiny_arv["moment_path"]
    ev = ARVRetrievalMoment(load_moment_db(db_path), _spec(tiny_arv), ex, device="cpu", **args)
    jev = jx.moment.ARVRetrievalMoment(jx.load_moment_db(db_path), tiny_arv["spec"], jex, **args)
    return ev, jev


def _dets(seed, n=120):
    """Seeded [start, end, score] rows over a 300 s video, a third of the
    scores rounded so that exact ties occur."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 300, n)
    dets = np.stack([start, start + rng.uniform(1, 60, n), rng.random(n)], axis=1)
    dets[::3, 2] = np.round(dets[::3, 2], 1)
    return dets.astype(np.float32)


class TestNMS:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("thresh", [0.3, 0.5])
    def test_keep_lists_equal_jax(self, jx, seed, thresh):
        dets = _dets(seed)
        assert len(np.unique(dets[:, 2])) < len(dets)  # ties are present
        want = jx.nms.temporal_nms_np(dets, thresh)
        assert nms.temporal_nms_np(dets, thresh) == want
        assert native_lib.available()
        assert nms.temporal_nms(dets, thresh) == want
        assert native_lib.temporal_nms(dets, thresh) == want

    def test_reference_fixture_and_empty(self):
        dets = np.array([[10, 20, 0.9], [12, 22, 0.8], [50, 60, 0.7]], np.float32)
        assert nms.temporal_nms(dets, 0.5) == nms.temporal_nms_np(dets, 0.5) == [0, 2]
        assert nms.temporal_nms(np.zeros((0, 3), np.float32), 0.5) == []


def _moment_case(seed, q=10, n_videos=9, per_video=25, n_labels=4):
    """A seeded postprocess input: 5 s-aligned windows (integer seconds, so
    the engine's fp32 and numpy's fp64 interval arithmetic agree exactly),
    fp32-exact IoUs, score ties, and up to three ignored videos a query."""
    rng = np.random.default_rng(seed)
    n = n_videos * per_video
    video_idx = np.repeat(np.arange(n_videos), per_video).astype(np.int32)
    start = 5.0 * rng.integers(0, 30, n)
    end = start + 5.0 * rng.integers(1, 10, n)
    hit_label = rng.integers(-1, n_labels, n).astype(np.int32)
    hit_iou = (rng.integers(0, 65, n) / 64.0) * (hit_label >= 0)
    scores = rng.normal(size=(q, n)).astype(np.float32)
    scores[:, ::5] = np.round(scores[:, ::5], 1)
    q_label = rng.integers(0, n_labels, q).astype(np.int32)
    ignore_vids = np.full((q, 4), -1, np.int32)
    for qi in range(q):
        k = int(rng.integers(0, 4))
        ignore_vids[qi, :k] = rng.choice(n_videos, size=k, replace=False)
    return dict(scores=scores, video_idx=video_idx, start_sec=start, end_sec=end,
                hit_label=hit_label, hit_iou=hit_iou, q_label=q_label, ignore_vids=ignore_vids)


class TestNativeEngine:
    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("robust", [True, False])
    def test_moment_batch_matches_jax_postprocess(self, jx, seed, robust):
        c = _moment_case(seed)
        ap, rec = native_lib.moment_batch(**c, nms_thresh=0.5, tiou_thresh=0.5, r_at_n=R_AT_N,
                                          robust=robust, n_threads=3)
        assert ap.shape == (10,) and rec.shape == (10, 3)
        for qi in range(10):
            iou_q = np.where(c["hit_label"] == c["q_label"][qi], c["hit_iou"], 0.0)
            ignore_q = np.isin(c["video_idx"], c["ignore_vids"][qi][c["ignore_vids"][qi] >= 0])
            want_ap, want_rec = jx.moment.moment_query_metrics(
                c["scores"][qi], c["video_idx"], c["start_sec"], c["end_sec"], iou_q, ignore_q,
                0.5, 0.5, R_AT_N, robust)
            assert abs(ap[qi] - want_ap) <= 1e-12
            np.testing.assert_allclose(rec[qi], want_rec, rtol=0, atol=1e-12)

    def test_bad_shapes_raise(self):
        c = _moment_case(0)
        c["hit_iou"] = c["hit_iou"][:-1]
        with pytest.raises(ValueError, match="per-moment"):
            native_lib.moment_batch(**c, nms_thresh=0.5, tiou_thresh=0.5, r_at_n=R_AT_N,
                                    robust=True)

    def test_concurrent_first_build(self, tmp_path):
        """Six threads start the engine at once with an empty build
        directory: each compiles into a temp file of its own and publishes it
        with os.replace, as processes would, and every caller gets a working
        library; one library is left and no temp file."""
        barrier = threading.Barrier(6)
        got, errors = [], []

        def start():
            try:
                barrier.wait(timeout=30)
                lib = native_lib.open_library(tmp_path)
                got.append((lib.vq_version(), native_lib.lib_path(tmp_path).exists()))
            except BaseException as e:  # re-raised below, in the test's thread
                errors.append(e)

        threads = [threading.Thread(target=start) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert errors == [] and got == [(1, True)] * 6
        assert [p.name for p in tmp_path.iterdir()] == [native_lib.lib_path(tmp_path).name]


class TestClosestHits:
    @pytest.mark.parametrize("seed", range(3))
    def test_equal_jax(self, jx, seed):
        rng = np.random.default_rng(seed)
        segs = [(float(s), float(s + rng.uniform(2, 30))) for s in rng.uniform(0, 100, 6)]
        labels = [f"c{int(rng.integers(4))}" for _ in segs]
        anns = [Annotation(segment=s, label=lab) for s, lab in zip(segs, labels)]
        janns = [jx.Annotation(segment=s, label=lab) for s, lab in zip(segs, labels)]
        allowed = {"c0", "c1", "c2"}
        starts = 5.0 * rng.integers(0, 20, 40)
        locs = np.stack([starts, starts + 5.0 * rng.integers(1, 8, 40)], axis=1)
        got_l, got_i = moment.closest_hits_vectorized(anns, locs, allowed)
        want_l, want_i = jx.moment.closest_hits_vectorized(janns, locs, allowed)
        assert got_l.tolist() == want_l.tolist()
        np.testing.assert_array_equal(got_i, want_i)
        for k in range(len(locs)):
            assert (moment.closest_hit(anns, locs[k], allowed)
                    == jx.moment.closest_hit(janns, locs[k], allowed))
        assert moment.closest_hits_vectorized([], locs[:2], allowed)[0].tolist() == ["", ""]


class TestMomentQueryMetrics:
    @pytest.mark.parametrize("seed", range(3))
    def test_equal_jax_with_diag(self, jx, seed):
        c = _moment_case(seed, q=3)
        for qi in range(3):
            iou_q = np.where(c["hit_label"] == c["q_label"][qi], c["hit_iou"], 0.0)
            ignore_q = np.isin(c["video_idx"], c["ignore_vids"][qi][c["ignore_vids"][qi] >= 0])
            args = (c["scores"][qi], c["video_idx"], c["start_sec"], c["end_sec"], iou_q,
                    ignore_q, 0.5, 0.5, R_AT_N, True)
            got = moment.moment_query_metrics(*args, return_diag=True)
            want = jx.moment.moment_query_metrics(*args, return_diag=True)
            assert got[:2] == want[:2]
            for key in ("valid", "tp", "scores"):
                np.testing.assert_array_equal(got[2][key], want[2][key])

    def test_ignored_moment_suppresses_a_valid_one(self, jx):
        """tests/test_retrieval.py's case: moment 1 dies to the ignored
        moment 0 in NMS, so nothing valid remains."""
        args = (np.array([0.9, 0.8]), np.array([0, 0]), np.array([0.0, 1.0]),
                np.array([10.0, 11.0]), np.array([0.0, 0.9]), np.array([True, False]))
        kw = dict(nms_threshold=0.5, r_at_n=(5,), robust=False)
        got = moment.moment_query_metrics(*args, **kw, return_diag=True)
        want = jx.moment.moment_query_metrics(*args, **kw, return_diag=True)
        assert got[:2] == want[:2] == (0.0, [0.0])
        assert got[2]["valid"].tolist() == want[2]["valid"].tolist() == []


class TestBuildGallery:
    def test_equal_jax(self, tiny_arv, jx):
        ev, jev = _evaluators(tiny_arv, jx, *_fake(jx))
        got, want = ev.build_gallery(), jev.build_gallery()
        feats, vidx, s_sec, e_sec, h_label, h_iou = got
        assert feats.shape == (160, 32) and len(set(vidx.tolist())) == 16  # 10 a video
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert set(ev.timings) == {"tape_build", "window_pool"}
        assert "" in set(h_label.tolist()) and h_iou.max() > 0.5


class TestMomentEval:
    @pytest.mark.parametrize("rank_chunk", [7, 128])
    @pytest.mark.parametrize("query_num", [1, 2])
    @pytest.mark.parametrize("engine", ["native", "numpy"])
    def test_metric_dict_matches_jax(self, tiny_arv, jx, ignoring_db, monkeypatch, engine,
                                     query_num, rank_chunk):
        if engine == "numpy":
            monkeypatch.setattr(native_lib, "available", lambda: False)
        ev, jev = _evaluators(tiny_arv, jx, *_fake(jx), db_path=ignoring_db,
                              query_num=query_num, rank_chunk=rank_chunk)
        got, want = ev.evaluation(), jev.evaluation()
        assert ev.resolved_engine == jev.resolved_engine.replace("numpy", engine) == engine
        jx.assert_close_tree(got, want, FAKE_TOL)
        assert 0.0 < got["map05"]["ap"] < 1.0 and set(got["map05"]["recall"]) == {"5", "10", "30"}
        assert set(ev.timings) == {"query_feats", "tape_build", "window_pool",
                                   "gallery_to_device", "score_device", "score_readback",
                                   "postprocess"}

    def test_cm_dict_matches_jax(self, tiny_arv, jx, ignoring_db):
        ev, jev = _evaluators(tiny_arv, jx, *_fake(jx), db_path=ignoring_db,
                              collect_diagnostics=True)
        got, want = ev.evaluation(), jev.evaluation()
        assert ev.resolved_engine == "numpy"  # diagnostics ride the numpy path
        items = got["map05"]["cm_dict"]["top30_result_list"]
        assert items and set(items[0][0]) == {"video_id", "loc", "hit_label", "hit_iou"}
        # the y_pred streams are raw scores from two frameworks' fp32
        # matmuls: 2e-5, as in the clip regime's test; all else 1e-6
        streams = [{k: d["map05"]["cm_dict"]["system_ap_dict"].pop(k)
                    for k in list(d["map05"]["cm_dict"]["system_ap_dict"])
                    if k.endswith("y_pred")} for d in (got, want)]
        assert streams[0]
        jx.assert_close_tree(streams[0], streams[1], 2e-5)
        jx.assert_close_tree(got, want, FAKE_TOL)
        plain, _ = _evaluators(tiny_arv, jx, *_fake(jx), db_path=ignoring_db)
        # the native path without diagnostics gives the same metrics
        jx.assert_close_tree({k: v for k, v in got["map05"].items() if k != "cm_dict"},
                             plain.evaluation()["map05"], FAKE_TOL)

    def test_bf16_readback(self, tiny_arv, jx):
        """bf16 scores widen to fp32 on the host; the metrics stay within
        rank-flip distance of the fp32 readback, and the port's bf16 path
        equals JAX's bf16 path within the same bounds."""
        runs = {}
        for dtype in ("float32", "bfloat16"):
            ev, jev = _evaluators(tiny_arv, jx, *_fake(jx), score_readback_dtype=dtype)
            runs[dtype] = ev.evaluation()["map05"], jev.evaluation()["map05"]
        for got in (runs["bfloat16"][0], runs["bfloat16"][1]):
            for want in (runs["float32"][0], runs["bfloat16"][1]):
                for key in ("ap", "base_map", "novel_map"):
                    assert abs(got[key] - want[key]) < BF16_AP_TOL, key
                for n in got["recall"]:
                    assert abs(got["recall"][n] - want["recall"][n]) < BF16_RECALL_TOL

    def test_read_cache_roundtrip(self, tiny_arv, jx, tmp_path):
        """The gallery cache the port writes, read back by the port and by
        the JAX package, gives identical results; another seed's extractor
        reading it gets the first run's gallery."""
        ex, jex = _fake(jx, cache_dir=str(tmp_path))
        ev, _ = _evaluators(tiny_arv, jx, ex, jex)
        first = ev.evaluation()
        assert (tmp_path / "moment_gallery" / "hit_label.npy").exists()
        ex2, jex2 = _fake(jx, cache_dir=str(tmp_path))
        ev2, jev2 = _evaluators(tiny_arv, jx, ex2, jex2, read_cache=True)
        assert ev2.evaluation() == first
        assert "tape_build" not in ev2.timings
        jx.assert_close_tree(jev2.evaluation(), first, FAKE_TOL)
        ex3, _ = _fake(jx, seed=99, cache_dir=str(tmp_path))
        ev3, _ = _evaluators(tiny_arv, jx, ex3, jex2, read_cache=True)
        gal = ev3.build_gallery()
        for got, key in zip(gal, ("feats", "video_idx", "start_sec", "end_sec", "hit_label",
                                  "hit_iou")):
            np.testing.assert_array_equal(got, np.load(tmp_path / "moment_gallery" / f"{key}.npy"))

    def test_engines(self, tiny_arv, jx):
        ex, _ = _fake(jx)
        db, spec = load_moment_db(tiny_arv["moment_path"]), _spec(tiny_arv)
        dev_ev = ARVRetrievalMoment(db, spec, ex, device="cpu", engine="device",
                                    moment_clip_sec=5, rank_chunk=64)
        dev_ev.evaluation()
        assert dev_ev.resolved_engine == "device"
        with pytest.raises(ValueError):
            ARVRetrievalMoment(db, spec, ex, device="cpu", engine="gpu")
        with pytest.raises(ValueError):
            ARVRetrievalMoment(db, spec, ex, device="cpu", score_readback_dtype="fp8")
        ev = ARVRetrievalMoment(db, spec, ex, device="cpu", moment_clip_sec=5, rank_chunk=64,
                                scan_chunks=4)
        assert ev.engine == "auto"
        ev.evaluation()
        assert ev.resolved_engine == "native"

    def test_cuda_default_raises_without_gpu(self, tiny_arv, jx):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        ex, _ = _fake(jx)
        with pytest.raises(RuntimeError, match="cuda"):
            ARVRetrievalMoment(load_moment_db(tiny_arv["moment_path"]), _spec(tiny_arv), ex)
        feats = np.zeros((2, 4), np.float32)
        with pytest.raises(RuntimeError, match="cuda"):
            MomentIndex(feats, ["a"], np.zeros(2, np.int64), np.zeros(2), np.ones(2))


def _moment_arrays(n_videos=6, per_video=40, c=16, seed=4):
    """tests/test_serve.py's moment index: 6 videos of 40 windows."""
    rng = np.random.default_rng(seed)
    g = n_videos * per_video
    feats = rng.normal(size=(g, c)).astype(np.float32)
    vidx = np.repeat(np.arange(n_videos), per_video)
    starts = rng.uniform(0, 80, g)
    ends = starts + rng.uniform(3, 40, g)
    return feats, [f"u{i}" for i in range(n_videos)], vidx, starts, ends


def _assert_same_moments(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(r["video_id"], r["start_sec"], r["end_sec"], r["rank"]) for r in g] == [
            (r["video_id"], r["start_sec"], r["end_sec"], r["rank"]) for r in w]
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w],
                                   rtol=0, atol=1e-5)


class TestMomentIndex:
    @pytest.mark.parametrize("k,pool", [(8, None), (8, 240), (3, 50), (30, 100)])
    def test_query_matches_jax(self, jx, k, pool):
        arrays = _moment_arrays()
        idx, jidx = MomentIndex(*arrays, device="cpu"), jx.MomentIndex(*arrays)
        q = np.random.default_rng(5).normal(size=(3, 16)).astype(np.float32)
        q[0] = arrays[0][17]  # a window's own feature: that window at rank 0
        got = idx.query(q, k=k, nms_threshold=0.5, candidate_pool=pool)
        _assert_same_moments(got, jidx.query(q, k=k, nms_threshold=0.5, candidate_pool=pool))
        assert got[0][0]["start_sec"] == arrays[3][17] and got[0][0]["video_id"] == "u0"
        np.testing.assert_array_equal(idx.topk(q, 9)[1], jidx.topk(q, 9)[1])
        assert idx.row_meta(45) == jidx.row_meta(45)

    def test_nms_suppresses_overlaps(self):
        feats = np.stack([np.ones(8), np.ones(8) * 0.99, -np.ones(8)]).astype(np.float32)
        idx = MomentIndex(feats, ["a", "b"], np.array([0, 0, 1]), np.array([0.0, 1.0, 0.0]),
                          np.array([10.0, 11.0, 10.0]), device="cpu")
        res = idx.query(np.ones((1, 8), np.float32), k=5, nms_threshold=0.5)[0]
        assert [r["video_id"] for r in res] == ["a", "b"]  # the overlapping twin died

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_save_load_across_packages(self, jx, tmp_path, direction):
        arrays = _moment_arrays(seed=7)
        idx, jidx = MomentIndex(*arrays, device="cpu"), jx.MomentIndex(*arrays)
        d = str(tmp_path / "midx")
        if direction == "jax_to_port":
            jidx.save(d)
            loaded, other = MomentIndex.load(d, device="cpu"), jidx
        else:
            idx.save(d)
            loaded, other = jx.MomentIndex.load(d), idx
        assert loaded.n == 240 and loaded.video_ids == arrays[1]
        np.testing.assert_array_equal(np.load(tmp_path / "midx" / "feats.npy"), arrays[0])
        q = np.random.default_rng(6).normal(size=(2, 16)).astype(np.float32)
        _assert_same_moments(loaded.query(q, k=5), other.query(q, k=5))
        # a gallery index saved over it drops the moment marker
        GalleryIndex(arrays[0], [{"video_id": "x"}] * 240, device="cpu").save(d)
        assert not (tmp_path / "midx" / "windows.npz").exists()


def _planted_ties(seed, n=40):
    """Four rows of scores with ties at the top, everywhere, straddling the
    8th score, and across the whole row."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(4, n)).astype(np.float32)
    s[0, [3, 9, 17, 33]] = 2.0
    s[1, :] = np.round(s[1, :])
    s[2, [30, 4, 11]] = s[2].max() + 1.0
    s[3, :] = 0.5
    return s


class TestTopkTies:
    @pytest.mark.parametrize("k", [1, 5, 8, 16, 40])
    def test_pool_alternative_equals_the_full_sort(self, k):
        """chip_smoke.py times ``torch.topk`` + a sort of the pool against
        the serving index's full stable sort; with planted ties both give
        the lower column first, so the timing compares like with like."""
        from chip_smoke import full_sort_topk, topk_then_pool_sort

        s = torch.from_numpy(_planted_ties(k))
        got, want = topk_then_pool_sort(s, k), full_sort_topk(s, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1][3].tolist() == list(range(k))

    @pytest.mark.parametrize("k", [3, 8, 17])
    def test_moment_index_topk_ties_equal_jax(self, jx, k):
        """Duplicate windows make exact score ties, some straddling the
        k-th row: the lower row comes first, as jax.lax.top_k orders it."""
        feats, video_ids, vidx, starts, ends = _moment_arrays(seed=k)
        feats[100:140] = feats[0:40]  # rows 100.. tie rows 0..
        feats[200:205] = feats[50]
        q = np.stack([feats[3], feats[50], feats[120]])
        idx = MomentIndex(feats, video_ids, vidx, starts, ends, device="cpu")
        jidx = jx.MomentIndex(feats, video_ids, vidx, starts, ends)
        got, want = idx.topk(q, k), jidx.topk(q, k)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1][0, :2].tolist() == [3, 103] and got[1][1, :2].tolist() == [50, 200]


class TestMomentService:
    def _service(self):
        arrays = _moment_arrays()
        idx = MomentIndex(*arrays, device="cpu")
        return QueryService(idx, max_wait_ms=1.0, moment_index=idx), idx, arrays

    def test_query_moments_matches_jax(self, jx):
        svc, idx, arrays = self._service()
        try:
            got = svc.query_moments(arrays[0][3], k=4, nms_threshold=0.5)
            feats_rows = svc.query_features(arrays[0][3], k=2)
        finally:
            svc.close()
        _assert_same_moments([got], jx.MomentIndex(*arrays).query(arrays[0][3:4], k=4))
        assert got[0]["video_id"] == "u0" and got[0]["start_sec"] == arrays[3][3]
        assert feats_rows[0]["start_sec"] == arrays[3][3]  # rows are windows

    def test_concurrent_moment_queries(self):
        svc, idx, arrays = self._service()
        rows = list(range(0, 240, 20))
        out = {}

        def one(r):
            out[r] = svc.query_moments(arrays[0][r], k=3)

        threads = [threading.Thread(target=one, args=(r,)) for r in rows]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        finally:
            svc.close()
        for r in rows:
            assert out[r] == idx.query(arrays[0][r : r + 1], k=3)[0]
            assert out[r][0]["start_sec"] == arrays[3][r]

    def test_http_endpoint(self):
        svc, _, arrays = self._service()
        srv = make_server(svc, host="127.0.0.1", port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/query/moments"
            body = json.dumps({"feature": arrays[0][50].tolist(), "k": 3, "nms": 0.4}).encode()
            with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=60) as r:
                res = json.load(r)["results"]
        finally:
            srv.shutdown()
            srv.server_close()
            svc.close()
            thread.join(timeout=30)
        assert res == svc.moment_index.query(arrays[0][50:51], k=3, nms_threshold=0.4)[0]
        assert res[0]["video_id"] == "u1" and res[0]["rank"] == 0


class TestServeMoment:
    def test_builds_saves_and_reloads(self, tiny_arv, jx, tmp_path):
        """No index on disk: ``--regime moment`` builds the moment index of
        the gallery videos through the trunk, saves it in the JAX server's
        format and serves /query/moments; a second start loads it (the
        windows.npz path) and answers the same. The windows equal the JAX
        evaluator's gallery over the same videos, the features within 1e-4."""
        from tests.test_torch_data import write_split_spec
        from tests.test_torch_serve import _serve_in_thread
        from tests.test_torch_trunk import full_model_variables, random_trunk_variables
        from vqwild_tpu.models import torch_export

        variables = full_model_variables(random_trunk_variables(seed=13))
        ckpt = str(tmp_path / "best.pth.tar")
        torch_export.save_reference_checkpoint(ckpt, variables, "baseline")
        spec_path = write_split_spec(tiny_arv, tmp_path / "spec.json")
        flags = dict(meta_split=spec_path, frame_store="synthetic", max_gallery=2,
                     input_size=32, test_frame=32, test_batch_size=4, moment_clip_sec=5,
                     max_clips_per_moment=26)
        argv = ["--index_dir", str(tmp_path / "idx"), "--port", "0", "--device", "cpu",
                "--max_wait_ms", "1", "--regime", "moment"]
        for k, v in flags.items():
            argv += [f"--{k}", str(v)]

        def ask(srv, row):
            url = f"http://127.0.0.1:{srv.server_address[1]}/query/moments"
            body = json.dumps({"feature": feats[row].tolist(), "k": 5}).encode()
            with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=60) as r:
                return json.load(r)["results"]

        srv, thread = _serve_in_thread(argv + ["--test_load", ckpt])
        try:
            feats = np.load(tmp_path / "idx" / "feats.npy")
            with np.load(tmp_path / "idx" / "windows.npz") as z:
                windows = {k: z[k] for k in z.files}
            built = [ask(srv, row) for row in (0, 13)]
        finally:
            srv.shutdown()
            thread.join(timeout=30)
        assert not thread.is_alive()
        assert feats.shape == (20, 512)  # 2 videos x 10 windows
        for res, row in zip(built, (0, 13)):
            assert res[0]["rank"] == 0 and res[0]["start_sec"] == windows["start_sec"][row]
            assert res[0]["end_sec"] == windows["end_sec"][row]

        srv, thread = _serve_in_thread(["--index_dir", str(tmp_path / "idx"), "--no_embed",
                                        "--port", "0", "--device", "cpu"])
        try:
            assert [ask(srv, row) for row in (0, 13)] == built
        finally:
            srv.shutdown()
            thread.join(timeout=30)
        assert not thread.is_alive()

        # what the JAX server builds, minus its model construction: the JAX
        # evaluator's gallery over the same two videos from the same weights
        import jax.numpy as jnp
        from vqwild_tpu.retrieval.features import make_feat_fn as jax_make_feat_fn

        jmodel = SimpleNamespace(dtype=jnp.float32, bn_eps=1e-3)
        jex = jx.Extractor(jax_make_feat_fn(jmodel, variables, wire="yuv420"), jx.Store(),
                           test_frames=32, test_batch_size=4, input_size=32, wire="yuv420")
        jev = jx.moment.ARVRetrievalMoment(jx.load_moment_db(tiny_arv["moment_path"]),
                                           tiny_arv["spec"], jex, moment_clip_sec=5,
                                           max_clips_per_moment=26)
        jev.gallery_videos = jev.gallery_videos[:2]
        jfeats, jvidx, js, je, _, _ = jev.build_gallery()
        for k, want in (("video_idx", jvidx), ("start_sec", js), ("end_sec", je)):
            np.testing.assert_array_equal(windows[k], want)
        assert json.loads((tmp_path / "idx" / "videos.json").read_text()) == [
            v.video_id for v in jev.gallery_videos]
        np.testing.assert_allclose(feats, jfeats, rtol=0, atol=1e-4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    def test_moment_metrics_match_cpu(self, cuda, tmp_path):
        """The moment evaluator's host engine on the card (K1 scores each
        chunk of 128, the native engine postprocesses) against the same
        evaluation on the CPU, on seeded fake features over a seeded moment DB of 60 videos
        (~18,000 windows): every metric within 1e-3, the rule
        ``chip_smoke.py`` holds the card to."""
        from chip_smoke import length_store, tree_max_diff, write_moment_db
        from vqwild_tpu_torch.data.labels import get_split

        spec_path, frames = write_moment_db(str(tmp_path), videos=60, queries=300, labels=30,
                                            seed=3)
        spec = get_split(spec_path)
        mdb = load_moment_db(spec.moment_db_json)

        def run(device):
            ex = FeatureExtractor(make_fake_feat_fn(512, seed=4), length_store(frames),
                                  test_frames=32, test_batch_size=30, fake=True)
            ev = ARVRetrievalMoment(mdb, spec, ex, device=device, engine="host")
            out = ev.evaluation()
            assert ev.resolved_engine == "native"
            return out

        before = distance.launches.n
        got = run(cuda)
        assert distance.launches.n == before + 3  # 300 queries: 3 chunks of 128
        assert tree_max_diff(got, run("cpu")) <= 1e-3
