"""Port's device moment engine (vqwild_tpu_torch/retrieval/moment_device.py
and the ``engine="device"|"auto"`` paths of retrieval/moment.py) against the
JAX package's on the CPU: bucket plans equal, blocked-NMS keep masks equal
bit for bit (and equal to a naive sequential greedy), engine metrics within
2e-6 (AP) and 1e-12 (recalls) of JAX's engine and of the host postprocess,
and the evaluator's metric dict within 1e-6 of JAX's device engine and of
the port's host engine.

As in test_torch_moment.py, every call into the JAX moment code runs with
the JAX native engine patched unavailable, and the JAX package is imported
inside a fixture, so that the ``cuda`` test at the end runs on a machine
that has only the port.
"""

import dataclasses
import functools
import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import load_moment_db
from vqwild_tpu_torch.ops import distance
from vqwild_tpu_torch.retrieval import ARVRetrievalMoment, FeatureExtractor, make_fake_feat_fn
from vqwild_tpu_torch.retrieval import moment, moment_device
from vqwild_tpu_torch.retrieval.moment_device import DeviceMomentEngine, _bucket_plan, _nms_sorted
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer

R_AT_N = (5, 10, 30)
FAKE_TOL = 1e-6
AP_TOL, RECALL_TOL = 2e-6, 1e-12


@pytest.fixture(scope="module")
def jx():
    """The JAX package's counterparts of what this file tests."""
    import jax.numpy as jnp

    from vqwild_tpu.data.frames import SyntheticFrameStore as JaxSyntheticFrameStore
    from vqwild_tpu.data.schema import load_moment_db as jax_load_moment_db
    from vqwild_tpu.native import lib as jax_native_lib
    from vqwild_tpu.retrieval import moment as jmoment
    from vqwild_tpu.retrieval import moment_device as jmd
    from vqwild_tpu.retrieval.features import FeatureExtractor as JaxFeatureExtractor
    from vqwild_tpu.retrieval.features import make_fake_feat_fn as jax_make_fake_feat_fn

    from tests.test_torch_trimmed import assert_close_tree

    return SimpleNamespace(
        jnp=jnp, Store=JaxSyntheticFrameStore, load_moment_db=jax_load_moment_db,
        native_lib=jax_native_lib, moment=jmoment, md=jmd, Extractor=JaxFeatureExtractor,
        make_fake_feat_fn=jax_make_fake_feat_fn, assert_close_tree=assert_close_tree)


@pytest.fixture(autouse=True)
def _jax_native_off(request, monkeypatch):
    """JAX's moment code on its numpy path; its native lib never loads."""
    if request.node.get_closest_marker("cuda") is None:
        jax_native_lib = request.getfixturevalue("jx").native_lib
        monkeypatch.setattr(jax_native_lib, "available", lambda: False)


def _random_world(rng, n_videos, max_w=40, grid=True):
    """tests/test_moment_device.py's seeded world, copied."""
    counts = rng.integers(1, max_w, n_videos)
    vidx = np.repeat(np.arange(n_videos), counts)
    starts, ends = [], []
    for c in counts:
        if grid:  # integer-second 5 s grid like enumerate_moment_windows
            p = rng.integers(0, 40, c) * 5
            length = rng.integers(1, 27, c) * 5
        else:
            p = rng.integers(0, 200, c)
            length = rng.integers(1, 131, c)
        starts.append(p)
        ends.append(p + length)
    s_sec = np.concatenate(starts).astype(np.float64)
    e_sec = np.concatenate(ends).astype(np.float64)
    g = len(vidx)
    labels = np.array([rng.choice(["a", "b", "c", ""]) for _ in range(g)])
    h_iou = np.where(labels == "", 0.0, rng.random(g))
    # sprinkle exact boundary tIoUs to pin >= semantics
    h_iou[rng.integers(0, g, max(1, g // 10))] = 0.5
    return vidx, s_sec, e_sec, labels, h_iou


class TestBucketPlan:
    @pytest.mark.parametrize("seed", range(3))
    def test_equal_jax(self, jx, seed):
        rng = np.random.default_rng(seed)
        counts = np.concatenate([[1, 16, 17, 40, 80, 160], rng.integers(1, 1100, 20)])
        vidx = np.repeat(np.arange(len(counts)), counts)
        got, want = _bucket_plan(vidx, len(counts)), jx.md._bucket_plan(vidx, len(counts))
        assert [b["w"] for b in got] == [b["w"] for b in want]
        for g, w in zip(got, want):
            for key in ("gather", "vglob"):
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
        seen = np.concatenate([b["gather"].ravel() for b in got])
        assert sorted(seen[seen < len(vidx)].tolist()) == list(range(len(vidx)))

    def test_over_the_cap_raises(self, jx):
        vidx = np.zeros(moment_device.MAX_MOMENTS_PER_VIDEO + 1, np.int64)
        for plan in (_bucket_plan, jx.md._bucket_plan):
            with pytest.raises(ValueError, match="max bucket"):
                plan(vidx, 1)


def _naive_nms(ss, st, en, thresh):
    """The textbook one-slot-at-a-time greedy over sorted members."""
    q, v, w = ss.shape
    keep = np.zeros((q, v, w), bool)
    for qi in range(q):
        for vi in range(v):
            supp = ss[qi, vi] == -np.inf
            ln = en[qi, vi] - st[qi, vi] + 1.0
            for i in range(w):
                if supp[i]:
                    continue
                inter = np.maximum(
                    0.0,
                    np.minimum(en[qi, vi, i], en[qi, vi]) - np.maximum(st[qi, vi, i], st[qi, vi])
                    + 1.0,
                )
                hit = inter * (1 + thresh) >= thresh * (ln[i] + ln)
                supp[i + 1 :] |= hit[i + 1 :]
            keep[qi, vi] = ~supp & (ss[qi, vi] > -np.inf)
    return keep


@functools.lru_cache(maxsize=None)
def _nms_case(w):
    """Sorted members of 3 queries x 4 videos at width ``w``: overlap-heavy
    5 s-grid geometry with duplicated windows, dense exact score ties, and
    pads at the tail as the engine lays them out; with the naive keep mask."""
    rng = np.random.default_rng(w)
    q, v = 3, 4
    st = (rng.integers(0, 30, (q, v, w)) * 5).astype(np.float32)
    en = st + (rng.integers(1, 27, (q, v, w)) * 5).astype(np.float32)
    st[:, :, 1::7], en[:, :, 1::7] = st[:, :, 0:1], en[:, :, 0:1]  # duplicates of slot 0
    ss = np.sort(np.round(rng.standard_normal((q, v, w)), 1).astype(np.float32))[..., ::-1].copy()
    n_pad = int(rng.integers(1, w // 2))
    ss[1:, :, w - n_pad :] = -np.inf
    st[1:, :, w - n_pad :] = 0.0
    en[1:, :, w - n_pad :] = -1.0
    return ss, st, en, _naive_nms(ss, st, en, 0.5)


class TestBlockedNMS:
    # 16/48/64: one block (K = W); 96, 192: K = 48 and 64; 80 and 160, which
    # no bucket width reaches: K = 16 and 32
    @pytest.mark.parametrize("w", [16, 48, 64, 80, 96, 160, 192])
    @pytest.mark.parametrize("tile_elems", [None, 700, 1])
    def test_keep_masks_equal_jax_and_naive(self, jx, w, tile_elems):
        ss, st, en, naive = _nms_case(w)
        kw = {} if tile_elems is None else {"tile_elems": tile_elems}
        got = _nms_sorted(torch.from_numpy(ss), torch.from_numpy(st), torch.from_numpy(en),
                          0.5, **kw).numpy()
        want = np.asarray(jx.md._nms_sorted(jx.jnp.asarray(ss), jx.jnp.asarray(st),
                                            jx.jnp.asarray(en), 0.5))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, naive)
        assert naive.any() and not naive[ss > -np.inf].all()  # NMS really suppressed

    def test_temporaries_stay_inside_the_tile(self, monkeypatch):
        """Every pairwise temporary of the cross-block pass holds at most
        ``tile_elems`` elements, and the result does not depend on the
        tiling."""
        ss, st, en, naive = _nms_case(192)
        sizes = []
        real = moment_device._pair_hits

        def spy(s_i, e_i, l_i, s_j, e_j, l_j, thresh):
            out = real(s_i, e_i, l_i, s_j, e_j, l_j, thresh)
            sizes.append(out.numel())
            return out

        monkeypatch.setattr(moment_device, "_pair_hits", spy)
        budget = 3 * 64 * 5
        got = _nms_sorted(torch.from_numpy(ss), torch.from_numpy(st), torch.from_numpy(en),
                          0.5, tile_elems=budget).numpy()
        np.testing.assert_array_equal(got, naive)
        assert max(sizes) <= 3 * 64 * 64  # the K x K matrix of one video at a time
        cross = [n for n in sizes if n % (64 * 64)]  # the cross-block tiles
        assert cross and max(cross) <= budget


def _compare(jx, scores, q_names, ig_lists, world, chunk, r_at_n=(3, 5, 100), robust=True):
    """The port's engine against JAX's engine and the port's host postprocess."""
    vidx, s_sec, e_sec, labels, h_iou = world
    n_videos = int(vidx.max()) + 1
    eng = DeviceMomentEngine(vidx, s_sec, e_sec, labels, h_iou, n_videos, chunk=chunk,
                             max_ignore=4, device="cpu")
    jeng = jx.md.DeviceMomentEngine(vidx, s_sec, e_sec, labels, h_iou, n_videos, chunk=chunk,
                                    max_ignore=4)
    ap, rec = eng.metrics(torch.from_numpy(scores), [eng.label_id(n) for n in q_names],
                          ig_lists, r_at_n, robust)
    jap, jrec = jeng.metrics(jx.jnp.asarray(scores), [jeng.label_id(n) for n in q_names],
                             ig_lists, r_at_n, robust)
    assert ap.shape == (len(q_names),) and rec.shape == (len(q_names), len(r_at_n))
    np.testing.assert_allclose(ap, jap, rtol=0, atol=AP_TOL)
    np.testing.assert_allclose(rec, jrec, rtol=0, atol=RECALL_TOL)
    for qi, name in enumerate(q_names):
        ap_h, rec_h = moment.moment_query_metrics(
            scores[qi], vidx, s_sec, e_sec, np.where(labels == name, h_iou, 0.0),
            np.isin(vidx, ig_lists[qi]), 0.5, 0.5, r_at_n, robust)
        assert abs(ap[qi] - ap_h) <= AP_TOL, f"query {qi}"
        np.testing.assert_allclose(rec[qi], rec_h, rtol=0, atol=RECALL_TOL)
    return ap, rec


class TestEngineMetrics:
    def test_randomized_with_exact_ties(self, jx):
        rng = np.random.default_rng(7)
        world = _random_world(rng, 17)
        scores = rng.standard_normal((12, len(world[0]))).astype(np.float32)
        scores[0, :8] = 0.25
        scores[5, 10:15] = scores[5, 9]
        ig = [list(rng.choice(17, rng.integers(0, 4), replace=False)) for _ in range(12)]
        _compare(jx, scores, ["a", "b", "c"] * 4, ig, world, chunk=12)

    def test_wide_videos_take_the_blocked_path(self, jx):
        rng = np.random.default_rng(11)
        world = _random_world(rng, 8, max_w=300)
        assert np.bincount(world[0]).max() > 96  # blocked buckets are reached
        scores = rng.standard_normal((6, len(world[0]))).astype(np.float32)
        scores[0, :100] = 0.5
        scores[2] = np.round(scores[2] * 4) / 4  # many cross-video ties
        _compare(jx, scores, ["a", "b", "c", "a", "b", "c"], [[], [1], [], [0, 3], [], [7]],
                 world, chunk=6)

    def test_partial_chunk_without_robust(self, jx):
        rng = np.random.default_rng(3)
        world = _random_world(rng, 9)
        scores = rng.standard_normal((3, len(world[0]))).astype(np.float32)
        _compare(jx, scores, ["a", "b", "a"], [[0], [], [2, 5]], world, chunk=8, robust=False)

    def test_all_gallery_ignored_query(self, jx):
        rng = np.random.default_rng(1)
        world = _random_world(rng, 4)
        scores = rng.standard_normal((1, len(world[0]))).astype(np.float32)
        ap, rec = _compare(jx, scores, ["a"], [[0, 1, 2, 3]], world, chunk=4)
        assert ap[0] == 0.0 and (rec == 0.0).all()

    def test_nongrid_geometry(self, jx):
        rng = np.random.default_rng(11)
        world = _random_world(rng, 11, grid=False)
        scores = rng.standard_normal((6, len(world[0]))).astype(np.float32)
        _compare(jx, scores, ["a", "c", "b", "a", "c", "b"], [[i] for i in range(6)], world,
                 chunk=6)


class TestScanDispatch:
    def test_scan_equals_per_chunk_dispatch(self):
        """dispatch_scan (the bank gather, K1's plain version and the chunk
        core for each chunk of a super-chunk) equals per-chunk dispatch on
        the same scores, replicated-pad chunks included."""
        rng = np.random.default_rng(13)
        vidx, s_sec, e_sec, labels, h_iou = _random_world(rng, 13)
        g, d = len(vidx), 8
        bank = rng.standard_normal((19, d)).astype(np.float32)
        scorer = GalleryScorer(rng.standard_normal((g, d)).astype(np.float32), device="cpu")
        scorer.set_query_bank(bank)
        engine = DeviceMomentEngine(vidx, s_sec, e_sec, labels, h_iou, 13, chunk=4,
                                    max_ignore=3, device="cpu")
        # 10 real queries → 3 chunks of 4, padded to 4 chunks → 2 super-chunks
        qe, b, s, total = 10, 4, 2, 16
        q_rows = np.full((total, 2), -1, np.int32)
        q_lab = np.zeros(total, np.int32)
        ig = np.full((total, 3), -1, np.int64)
        for i in range(qe):
            nsel = int(rng.integers(1, 3))
            q_rows[i, :nsel] = rng.choice(19, nsel, replace=False)
            q_lab[i] = engine.label_id(str(rng.choice(["a", "b", "c"])))
            nig = int(rng.integers(0, 3))
            ig[i, :nig] = rng.choice(13, nig, replace=False)
        q_rows[qe:], q_lab[qe:], ig[qe:] = q_rows[0], q_lab[0], ig[0]
        scan_ap, scan_rec = [], []
        for p in range(0, total // b, s):
            rows = slice(p * b, (p + s) * b)
            ap_p, rec_p = engine.finalize_scan(engine.dispatch_scan(
                scorer.q_bank, scorer.g_dev, q_rows[rows].reshape(s, b, 2),
                q_lab[rows].reshape(s, b), ig[rows].reshape(s, b, 3), (3, 5), True))
            scan_ap.append(ap_p)
            scan_rec.append(rec_p)
        scan_ap, scan_rec = np.concatenate(scan_ap), np.concatenate(scan_rec)
        assert scan_ap.shape == (total,) and scan_rec.shape == (total, 2)
        for c in range(0, qe, b):
            n = min(b, qe - c)
            ap_c, rec_c = engine.metrics(
                scorer.scores_from_bank(q_rows[c : c + n]), q_lab[c : c + n],
                [list(r[r >= 0]) for r in ig[c : c + n]], (3, 5), True)
            np.testing.assert_array_equal(scan_ap[c : c + n], ap_c)
            np.testing.assert_array_equal(scan_rec[c : c + n], rec_c)


def _spec(tiny_arv):
    return SplitSpec(**dataclasses.asdict(tiny_arv["spec"]))


def _fake(jx, seed=0):
    args = dict(test_frames=8, test_batch_size=4, fake=True)
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


def _evaluator(tiny_arv, ex, db_path, **kw):
    args = dict(moment_clip_sec=5, r_at_n=R_AT_N, rank_chunk=7, workers=3, device="cpu")
    args.update(kw)
    return ARVRetrievalMoment(load_moment_db(db_path), _spec(tiny_arv), ex, **args)


DEVICE_TIMINGS = {"query_feats", "tape_build", "window_pool", "engine_build",
                  "gallery_to_device", "metrics_device", "metrics_readback"}


class TestEvaluator:
    @pytest.mark.parametrize("scan_chunks", [0, 4])
    @pytest.mark.parametrize("query_num", [1, 2])
    def test_metric_dict_matches_jax_and_host(self, tiny_arv, jx, ignoring_db, scan_chunks,
                                              query_num):
        ex, jex = _fake(jx)
        ev = _evaluator(tiny_arv, ex, ignoring_db, engine="device", scan_chunks=scan_chunks,
                        query_num=query_num)
        jev = jx.moment.ARVRetrievalMoment(
            jx.load_moment_db(ignoring_db), tiny_arv["spec"], jex, moment_clip_sec=5,
            r_at_n=R_AT_N, rank_chunk=7, workers=3, engine="device", scan_chunks=scan_chunks,
            query_num=query_num)
        got, want = ev.evaluation(), jev.evaluation()
        assert ev.resolved_engine == jev.resolved_engine == "device"
        jx.assert_close_tree(got, want, FAKE_TOL)
        host = _evaluator(tiny_arv, _fake(jx)[0], ignoring_db, engine="host",
                          query_num=query_num)
        jx.assert_close_tree(got, host.evaluation(), FAKE_TOL)
        assert host.resolved_engine == "native"
        assert 0.0 < got["map05"]["ap"] < 1.0
        assert set(ev.timings) == DEVICE_TIMINGS | ({"score_device"} if scan_chunks == 0 else set())

    def test_engine_device_no_longer_raises(self, tiny_arv, jx):
        ev = _evaluator(tiny_arv, _fake(jx)[0], tiny_arv["moment_path"], engine="device",
                        rank_chunk=64)
        assert ev.engine == "device"
        ev.evaluation()
        assert ev.resolved_engine == "device"


class TestEngineChoice:
    @pytest.mark.parametrize("engine,device,diagnostics,want", [
        ("auto", "cuda", False, True),
        ("auto", "cuda", True, False),
        ("auto", "cpu", False, False),
        ("device", "cpu", False, True),
        ("device", "cpu", True, True),
        ("device", "cuda", True, True),
        ("host", "cuda", False, False),
        ("host", "cpu", False, False),
    ])
    def test_rule_is_jax_rule(self, engine, device, diagnostics, want):
        """JAX's rule with ``jax.default_backend() != "cpu"`` read as a cuda
        device (torch.device("cuda") needs no GPU to be named)."""
        vidx = np.repeat(np.arange(3), 20)
        assert moment.use_device_engine(engine, torch.device(device), diagnostics, vidx) == want
        assert not moment.use_device_engine(engine, torch.device(device), diagnostics,
                                            np.zeros(0, np.int64)) or engine == "device"

    def test_auto_on_cpu_takes_the_host_engine(self, tiny_arv, jx):
        ev = _evaluator(tiny_arv, _fake(jx)[0], tiny_arv["moment_path"])
        assert ev.engine == "auto"
        ev.evaluation()
        assert ev.resolved_engine == "native"

    def test_diagnostics_take_the_numpy_path(self, tiny_arv, jx):
        ev = _evaluator(tiny_arv, _fake(jx)[0], tiny_arv["moment_path"],
                        collect_diagnostics=True)
        out = ev.evaluation()
        assert ev.resolved_engine == "numpy" and "cm_dict" in out["map05"]

    @pytest.mark.parametrize("engine", ["device", "auto"])
    def test_video_over_the_cap_falls_back_with_a_warning(self, tiny_arv, jx, monkeypatch,
                                                          caplog, engine):
        monkeypatch.setattr(moment_device, "MAX_MOMENTS_PER_VIDEO", 5)  # 10 windows a video
        vidx = np.repeat(np.arange(3), 10)
        logger = logging.getLogger("vqwild_tpu_torch")
        logger.addHandler(caplog.handler)
        try:
            assert not moment.use_device_engine(engine, torch.device("cuda"), False, vidx)
            if engine == "device":  # "auto" on the CPU takes the host engine anyway
                ev = _evaluator(tiny_arv, _fake(jx)[0], tiny_arv["moment_path"], engine=engine)
                ev.evaluation()
                assert ev.resolved_engine == "native"
        finally:
            logger.removeHandler(caplog.handler)
        warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
        assert any("10 moments > the 5 bucket cap" in m for m in warnings), warnings


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    def test_device_engine_on_the_card_matches_the_host_engine(self, cuda):
        """The device engine on the card against the host postprocess on the
        CPU, with a +0.0 / -0.0 score tie planted (equal under numpy's
        stable sort and torch's): every metric within 1e-3; then through
        dispatch_scan, K1 once per chunk."""
        rng = np.random.default_rng(17)
        world = _random_world(rng, 20, max_w=300)
        vidx, s_sec, e_sec, labels, h_iou = world
        g = len(vidx)
        names = ["a", "b", "c", "a", "b", "c", "a", "b"]
        scores = rng.standard_normal((8, g)).astype(np.float32)
        scores[:, 3], scores[:, 4], scores[:, g - 1] = 0.0, -0.0, -0.0  # ±0.0 ties
        ig = [[], [1], [2, 5], [], [0], [], [19], []]
        eng = DeviceMomentEngine(vidx, s_sec, e_sec, labels, h_iou, 20, chunk=8, max_ignore=4,
                                 device=cuda)
        ap, rec = eng.metrics(torch.from_numpy(scores).to(cuda),
                              [eng.label_id(n) for n in names], ig, (3, 5, 100), True)
        for qi, name in enumerate(names):
            ap_h, rec_h = moment.moment_query_metrics(
                scores[qi], vidx, s_sec, e_sec, np.where(labels == name, h_iou, 0.0),
                np.isin(vidx, ig[qi]), 0.5, 0.5, (3, 5, 100), True)
            assert abs(ap[qi] - ap_h) <= 1e-3
            np.testing.assert_allclose(rec[qi], rec_h, rtol=0, atol=1e-3)

        bank = rng.standard_normal((8, 16)).astype(np.float32)
        gal = rng.standard_normal((g, 16)).astype(np.float32)
        scorer = GalleryScorer(gal, device=cuda)
        scorer.set_query_bank(bank)
        q_rows = np.arange(16).reshape(2, 8, 1).astype(np.int32) % 8
        q_lab = np.array([[eng.label_id(n) for n in names]] * 2, np.int32)
        ig_arr = np.full((2, 8, 4), -1, np.int64)
        before = distance.launches.n
        ap_s, rec_s = eng.finalize_scan(eng.dispatch_scan(
            scorer.q_bank, scorer.g_dev, q_rows, q_lab, ig_arr, (3, 5, 100), True))
        assert distance.launches.n == before + 2
        cpu_scores = -((bank[:, None, :].astype(np.float64) - gal[None]) ** 2).sum(-1)
        for qi, name in enumerate(names):
            ap_h, rec_h = moment.moment_query_metrics(
                cpu_scores[qi].astype(np.float32), vidx, s_sec, e_sec,
                np.where(labels == name, h_iou, 0.0), np.zeros(g, bool), 0.5, 0.5,
                (3, 5, 100), True)
            for j in (qi, qi + 8):
                assert abs(ap_s[j] - ap_h) <= 1e-3
                np.testing.assert_allclose(rec_s[j], rec_h, rtol=0, atol=1e-3)
