"""The clip and moment evaluators, the query-sharded device moment engine
and the serving indexes under a mesh, on the CPU with gloo, against the JAX
package's mesh modes and the port's single process.

- ``ARVRetrievalClip(mesh=)`` and ``ARVRetrievalMoment(mesh=)`` on the host
  and on the device engine, on the tiny DB (its moment DB with six queries
  moved into gallery videos, so that the ignore sets remove moments) with
  seeded fake features: every metric within 1e-6 of JAX's evaluator on a
  mesh of as many devices, and equal to the port's single process.
- ``DeviceMomentEngine(mesh=)``: a chunk of 2W queries with exact ties
  across the shard boundary and a partial one of 2W - 1, the gallery's
  padded columns set far above every real score (never gathered): AP within
  2e-6 and recalls within 1e-12 of JAX's mesh engine and of the host
  postprocess, equal to the port's engine on one process.
- ``GalleryIndex``/``MomentIndex(mesh=)`` over a ragged gallery with a
  duplicated row across a shard boundary: the top-k rows equal to JAX's
  mesh index and to the one process (scores 1e-5 against JAX's, equal to
  the one process's), the NMS query equal to the one process's, and
  ``save`` → ``load`` under the mesh: one directory written by rank 0 with
  the whole gallery, answering as before.

The ranks run in spawned processes that import no JAX
(tests/test_torch_parallel.spawn); W = 2 and 4.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import child_mesh, load_ranks, save_rank, spawn
from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import get_split
from vqwild_tpu_torch.data.schema import load_moment_db
from vqwild_tpu_torch.retrieval import ARVRetrievalClip, ARVRetrievalMoment, FeatureExtractor
from vqwild_tpu_torch.retrieval.features import make_fake_feat_fn
from vqwild_tpu_torch.retrieval.moment_device import DeviceMomentEngine
from vqwild_tpu_torch.serve.index import GalleryIndex, MomentIndex

METRIC_TOL = 1e-6
AP_TOL, RECALL_TOL = 2e-6, 1e-12
SCORE_TOL = 1e-5
CLIP_KW = dict(clip_sec=6, r_at_n=(5, 10), rank_chunk=16, check_completeness=False)
# rank_chunk 7: the device engine's chunk of 7 rounds to 6 queries at W = 2
# and 4 at W = 4, so the 18 queries make several chunks, the last partial
MOMENT_KW = dict(moment_clip_sec=5, max_clips_per_moment=3, r_at_n=(5, 10, 30), rank_chunk=7,
                 workers=2)
ENGINE_R_AT_N = (3, 5, 100)
INDEX_K, POOL = 10, 24
PAD_SCORE = 1e6  # the padded gallery columns: above every real score


def fake_extractor():
    return FeatureExtractor(make_fake_feat_fn(32, seed=3), SyntheticFrameStore(), test_frames=8,
                            test_batch_size=4, input_size=64, fake=True)


def engine_world(seed, n_videos):
    from tests.test_torch_moment_device import _random_world

    return _random_world(np.random.default_rng(seed), n_videos)


def tie_case(world_size):
    """2W queries, ties of query 1 across the first shard boundary of the
    moments."""
    rng = np.random.default_rng(23)
    world = engine_world(23, 21)
    g = len(world[0])
    names = (["a", "b", "c"] * 6)[: 2 * world_size]
    scores = rng.standard_normal((len(names), g)).astype(np.float32)
    edge = -(-g // world_size)
    scores[1, edge - 3 : edge + 3] = 0.5
    ig = [sorted(int(v) for v in rng.choice(21, rng.integers(0, 4), replace=False))
          for _ in names]
    return world, names, scores, ig


def partial_case(world_size):
    """2W - 1 queries against a chunk of 2W."""
    rng = np.random.default_rng(29)
    world = engine_world(29, 7)
    names = (["a", "b", "c"] * 6)[: 2 * world_size - 1]
    scores = rng.standard_normal((len(names), len(world[0]))).astype(np.float32)
    ig = [[i % 7] if i % 2 else [] for i in range(len(names))]
    return world, names, scores, ig


def index_case():
    """A ragged gallery (37 rows) whose rows 18 and 19 (the shard boundary
    at W = 2) and 29 and 30 (at W = 4) are equal, 5 queries of which the
    first two lie next to those pairs and the third next to the last row
    (whose copies pad the gallery under a mesh), and moment windows over 6
    videos."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(37, 16)).astype(np.float32)
    g[19], g[30] = g[18], g[29]
    q = rng.normal(size=(5, 16)).astype(np.float32)
    q[0], q[1], q[2] = g[18] + 0.01, g[29] + 0.01, g[36] + 0.01
    vidx = np.sort(rng.integers(0, 6, 37))
    start = rng.integers(0, 40, 37).astype(np.float64)
    end = start + rng.integers(5, 30, 37)
    meta = [{"video_id": f"v{i}", "label": "l", "retrieval_type": "base"} for i in range(37)]
    return g, q, meta, vidx, start, end


# ---- the children ----

def _engine_metrics(case, chunk, mesh=None, pad_columns=0):
    """The port's engine on ``case``; ``pad_columns`` columns of PAD_SCORE
    past the gallery, as a padded gallery's scorer gives them."""
    world, names, scores, ig = case
    vidx, s_sec, e_sec, labels, h_iou = world
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    eng = DeviceMomentEngine(vidx, s_sec, e_sec, labels, h_iou, int(vidx.max()) + 1,
                             chunk=chunk, max_ignore=4, **kw)
    if pad_columns:
        scores = np.concatenate([scores, np.full((len(scores), pad_columns), PAD_SCORE,
                                                 np.float32)], axis=1)
    ap, rec = eng.metrics(torch.from_numpy(scores), [eng.label_id(n) for n in names], ig,
                          ENGINE_R_AT_N, True)
    return eng.chunk, ap, rec


def child_clipmoment(in_path, out_dir):
    """Each evaluation under the mesh (rank 0: also in one process), the
    engine cases, the indexes and their round trip."""
    mesh = child_mesh()
    d = np.load(in_path)
    spec = get_split(str(d["spec"]))
    mdb = load_moment_db(str(d["moment_db"]))
    out = {}
    runs = {"clip": lambda **kw: ARVRetrievalClip(mdb, spec, fake_extractor(), **CLIP_KW, **kw),
            "host": lambda **kw: ARVRetrievalMoment(mdb, spec, fake_extractor(), engine="host",
                                                    **MOMENT_KW, **kw),
            "device": lambda **kw: ARVRetrievalMoment(mdb, spec, fake_extractor(),
                                                      engine="device", **MOMENT_KW, **kw)}
    for name, make in runs.items():
        ev = make(mesh=mesh)
        out[name] = json.dumps(ev.evaluation(), default=float)
        out[f"{name}_engine"] = getattr(ev, "resolved_engine", "")
        if mesh.rank == 0:
            out[f"{name}_single"] = json.dumps(make(device="cpu").evaluation(), default=float)

    w = mesh.size
    for name, case in (("ties", tie_case(w)), ("partial", partial_case(w))):
        chunk, ap, rec = _engine_metrics(case, 2 * w + 1, mesh=mesh, pad_columns=w)
        out[f"{name}_chunk"], out[f"{name}_ap"], out[f"{name}_rec"] = chunk, ap, rec
        _, ap1, rec1 = _engine_metrics(case, chunk)
        out[f"{name}_ap_single"], out[f"{name}_rec_single"] = ap1, rec1

    g, q, meta, vidx, start, end = index_case()
    vids = [f"g{i}" for i in range(6)]
    gi = GalleryIndex(g, meta, mesh=mesh)
    mi = MomentIndex(g, vids, vidx, start, end, mesh=mesh)
    out["n_padded"] = gi.scorer.n_padded
    out["g_s"], out["g_i"] = gi.topk(q, INDEX_K)
    out["m_s"], out["m_i"] = mi.topk(q, INDEX_K)
    out["m_query"] = json.dumps(mi.query(q, k=5, candidate_pool=POOL))
    g1 = GalleryIndex(g, meta, device="cpu")
    m1 = MomentIndex(g, vids, vidx, start, end, device="cpu")
    out["g_s1"], out["g_i1"] = g1.topk(q, INDEX_K)
    out["m_s1"], out["m_i1"] = m1.topk(q, INDEX_K)
    out["m_query1"] = json.dumps(m1.query(q, k=5, candidate_pool=POOL))
    gi.save(str(d["gallery_dir"]))
    mi.save(str(d["moment_dir"]))
    out["g_loaded_i"] = GalleryIndex.load(str(d["gallery_dir"]), mesh=mesh).topk(q, INDEX_K)[1]
    out["m_loaded_query"] = json.dumps(MomentIndex.load(str(d["moment_dir"]), mesh=mesh).query(
        q, k=5, candidate_pool=POOL))
    save_rank(out_dir, mesh.rank, **out)


# ---- the JAX side and the run ----

@pytest.fixture(scope="module")
def moment_db(tiny_arv, tmp_path_factory):
    """The tiny moment DB with six queries moved into gallery videos
    (tests/test_torch_moment_device.py's ``ignoring_db``)."""
    doc = json.loads(open(tiny_arv["moment_path"]).read())
    for qi, gi in zip(range(0, 24, 4), range(0, 16, 3)):
        doc["query"][qi]["video_id"] = doc["gallery"][gi]["video_id"]
    path = tmp_path_factory.mktemp("moment_db") / "arv_db_tiny_untrimmed.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _jax_engine(jx, jmesh, case, chunk, world_size):
    from jax.sharding import NamedSharding, PartitionSpec as P

    world, names, scores, ig = case
    vidx, s_sec, e_sec, labels, h_iou = world
    eng = jx.md.DeviceMomentEngine(vidx, s_sec, e_sec, labels, h_iou, int(vidx.max()) + 1,
                                   chunk=chunk, max_ignore=4, mesh=jmesh)
    padded = np.pad(scores, ((0, 0), (0, (-scores.shape[1]) % world_size)))
    dev = jx.jax.device_put(padded, NamedSharding(jmesh, P(None, "data")))
    return eng.chunk, eng.metrics(dev, [eng.label_id(n) for n in names], ig, ENGINE_R_AT_N,
                                  True)


@pytest.fixture(scope="module", params=[2, 4])
def run(request, tiny_arv, moment_db, tmp_path_factory):
    import jax

    from tests.test_torch_data import write_split_spec
    from vqwild_tpu.data.frames import SyntheticFrameStore as JaxStore
    from vqwild_tpu.data.schema import load_moment_db as jax_load_moment_db
    from vqwild_tpu.native import lib as jax_native_lib
    from vqwild_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vqwild_tpu.retrieval import ARVRetrievalClip as JaxClip
    from vqwild_tpu.retrieval import ARVRetrievalMoment as JaxMoment
    from vqwild_tpu.retrieval import moment_device as jmd
    from vqwild_tpu.retrieval.features import FeatureExtractor as JaxExtractor
    from vqwild_tpu.retrieval.features import make_fake_feat_fn as jax_fake
    from vqwild_tpu.serve.index import GalleryIndex as JaxGalleryIndex
    from vqwild_tpu.serve.index import MomentIndex as JaxMomentIndex

    world = request.param
    tmp = tmp_path_factory.mktemp(f"clipmoment{world}")
    jx = SimpleNamespace(jax=jax, md=jmd)
    jmesh = jax_make_mesh(devices=jax.devices()[:world])

    def jex():
        return JaxExtractor(jax_fake(32, seed=3), JaxStore(), test_frames=8, test_batch_size=4,
                            input_size=64, fake=True)

    mdb = jax_load_moment_db(moment_db)
    want = {}
    # JAX's moment code on its numpy path, as tests/test_torch_moment_device.py runs it
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_lib, "available", lambda: False)
        want["clip"] = JaxClip(mdb, tiny_arv["spec"], jex(), mesh=jmesh, **CLIP_KW).evaluation()
        for engine in ("host", "device"):
            ev = JaxMoment(mdb, tiny_arv["spec"], jex(), engine=engine, mesh=jmesh, **MOMENT_KW)
            want[engine] = ev.evaluation()
            want[f"{engine}_engine"] = ev.resolved_engine
    for name, case in (("ties", tie_case(world)), ("partial", partial_case(world))):
        want[name] = _jax_engine(jx, jmesh, case, 2 * world + 1, world)
    g, q, meta, vidx, start, end = index_case()
    want["g"] = JaxGalleryIndex(g, meta, mesh=jmesh).topk(q, INDEX_K)
    want["m"] = JaxMomentIndex(g, [f"g{i}" for i in range(6)], vidx, start, end,
                               mesh=jmesh).topk(q, INDEX_K)
    spec = write_split_spec(tiny_arv, tmp / "spec.json")
    np.savez(tmp / "in.npz", spec=np.array(spec), moment_db=np.array(moment_db),
             gallery_dir=np.array(str(tmp / "gallery_index")),
             moment_dir=np.array(str(tmp / "moment_index")))
    spawn(world, "tests.test_torch_parallel_clipmoment:child_clipmoment", tmp / "in.npz", tmp,
          log_dir=tmp)
    return SimpleNamespace(world=world, tmp=tmp, want=want, res=load_ranks(tmp, world))


def _tree(r, key):
    return json.loads(str(r[key]))


class TestEvaluators:
    @pytest.mark.parametrize("name", ["clip", "host", "device"])
    def test_against_jax_mesh_evaluator(self, run, name):
        from tests.test_torch_trimmed import assert_close_tree

        want = json.loads(json.dumps(run.want[name], default=float))
        for r in run.res:
            assert_close_tree(_tree(r, name), want, METRIC_TOL)
        engines = {str(r[f"{name}_engine"]) for r in run.res}
        if name == "device":
            assert engines == {run.want["device_engine"]} == {"device"}
        elif name == "host":  # JAX's on its numpy path here; the engines are metric-equal
            assert len(engines) == 1 and engines <= {"native", "numpy"}

    @pytest.mark.parametrize("name", ["clip", "host", "device"])
    def test_against_the_single_process(self, run, name):
        """Every rank returns one process's metrics, bit for bit."""
        single = _tree(run.res[0], f"{name}_single")
        assert 0.0 < (single["ap"] if name == "clip" else single["map05"]["ap"]) < 1.0
        for r in run.res:
            assert _tree(r, name) == single


class TestDeviceEngine:
    @pytest.mark.parametrize("name", ["ties", "partial"])
    def test_against_jax_host_and_one_process(self, run, name):
        """The chunk rounds to a multiple of W as JAX's does; the W padded
        columns at PAD_SCORE, above every real score, never enter (the
        one process's engine sees none); every rank returns the whole
        chunk."""
        from vqwild_tpu_torch.retrieval.moment import moment_query_metrics

        case = (tie_case if name == "ties" else partial_case)(run.world)
        world, names, scores, ig = case
        vidx, s_sec, e_sec, labels, h_iou = world
        jchunk, (jap, jrec) = run.want[name]
        for r in run.res:
            assert int(r[f"{name}_chunk"]) == jchunk == 2 * run.world
            ap, rec = r[f"{name}_ap"], r[f"{name}_rec"]
            assert ap.shape == (len(names),) and rec.shape == (len(names), len(ENGINE_R_AT_N))
            np.testing.assert_allclose(ap, jap, rtol=0, atol=AP_TOL)
            np.testing.assert_allclose(rec, jrec, rtol=0, atol=RECALL_TOL)
            np.testing.assert_array_equal(ap, r[f"{name}_ap_single"])
            np.testing.assert_array_equal(rec, r[f"{name}_rec_single"])
        for qi, qname in enumerate(names):
            ap_h, rec_h = moment_query_metrics(
                scores[qi], vidx, s_sec, e_sec, np.where(labels == qname, h_iou, 0.0),
                np.isin(vidx, ig[qi]), 0.5, 0.5, ENGINE_R_AT_N, True)
            assert abs(run.res[0][f"{name}_ap"][qi] - ap_h) <= AP_TOL, qi
            np.testing.assert_allclose(run.res[0][f"{name}_rec"][qi], rec_h, rtol=0,
                                       atol=RECALL_TOL)


class TestIndexes:
    def test_topk_against_jax_and_one_process(self, run):
        jg_s, jg_i = run.want["g"]
        jm_s, jm_i = run.want["m"]
        for r in run.res:
            assert int(r["n_padded"]) % run.world == 0
            np.testing.assert_array_equal(r["g_i"], np.asarray(jg_i))
            np.testing.assert_allclose(r["g_s"], np.asarray(jg_s), rtol=0, atol=SCORE_TOL)
            np.testing.assert_array_equal(r["m_i"], np.asarray(jm_i))
            np.testing.assert_allclose(r["m_s"], np.asarray(jm_s), rtol=0, atol=SCORE_TOL)
            np.testing.assert_array_equal(r["g_i"], r["g_i1"])
            np.testing.assert_array_equal(r["g_s"], r["g_s1"])
            np.testing.assert_array_equal(r["m_i"], r["m_i1"])
            assert (r["g_i"] < 37).all()
        # the duplicated rows: the lower first, next to each other; the
        # last row first for the third query, its padding copies nowhere
        assert list(run.res[0]["g_i"][0][:2]) == [18, 19]
        assert list(run.res[0]["g_i"][1][:2]) == [29, 30]
        assert run.res[0]["g_i"][2][0] == 36

    def test_moment_query_against_one_process(self, run):
        for r in run.res:
            assert _tree(r, "m_query") == _tree(r, "m_query1")
            assert all(len(q) == 5 for q in _tree(r, "m_query"))

    def test_save_load_round_trip(self, run):
        """Rank 0 writes the whole gallery once; every rank loads it under
        the mesh and answers as before."""
        g = index_case()[0]
        saved = np.load(run.tmp / "gallery_index" / "feats.npy")
        np.testing.assert_array_equal(saved, g)
        np.testing.assert_array_equal(np.load(run.tmp / "moment_index" / "feats.npy"), g)
        assert sorted(p.name for p in (run.tmp / "gallery_index").iterdir()) == [
            "feats.npy", "meta.json"]
        assert sorted(p.name for p in (run.tmp / "moment_index").iterdir()) == [
            "feats.npy", "videos.json", "windows.npz"]
        for r in run.res:
            np.testing.assert_array_equal(r["g_loaded_i"], r["g_i"])
            assert _tree(r, "m_loaded_query") == _tree(r, "m_query")
