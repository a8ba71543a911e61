"""Port's trimmed evaluator and feature extractor (vqwild_tpu_torch/
retrieval/trimmed.py, features.py) against the JAX package's on the CPU, on
the tiny ARV dataset: the metric dict from the same seeded fake features
(1e-6), perfect features, the feature cache in both directions, the
diagnostics payload, and the slice end to end from the same weights (JAX
variables → convert → the port's trunk; features and metrics within 1e-4).
"""

import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trunk import full_model_variables, random_trunk_variables
from vqwild_tpu.data.frames import SyntheticFrameStore as JaxSyntheticFrameStore
from vqwild_tpu.data.schema import load_trimmed_db as jax_load_trimmed_db
from vqwild_tpu.retrieval.features import FeatureExtractor as JaxFeatureExtractor
from vqwild_tpu.retrieval.features import make_fake_feat_fn as jax_make_fake_feat_fn
from vqwild_tpu.retrieval.features import make_feat_fn as jax_make_feat_fn
from vqwild_tpu.retrieval.trimmed import ARVRetrievalTrimmed as JaxARVRetrievalTrimmed
from vqwild_tpu_torch.data.frames import PackedYUV420FrameStore, SyntheticFrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import load_trimmed_db
from vqwild_tpu_torch.models.convert import state_dict_from_jax, trunk_from_state_dict
from vqwild_tpu_torch.ops import ranking
from vqwild_tpu_torch.retrieval import (
    ARVRetrievalTrimmed,
    FeatureExtractor,
    make_fake_feat_fn,
    make_feat_fn,
)

R_AT_N = (5, 10, 30)
FAKE_TOL = 1e-6  # same features: only the order of the metric sums differs
E2E_TOL = 1e-4  # features from two frameworks' convs


def _spec(tiny_arv):
    return SplitSpec(**dataclasses.asdict(tiny_arv["spec"]))


def _extractor(cls, feat_fn, store, **kw):
    args = dict(test_frames=8, test_batch_size=4, input_size=64, fake=True)
    args.update(kw)
    return cls(feat_fn, store, **args)


def _fake(**kw):
    return _extractor(FeatureExtractor, make_fake_feat_fn(32, seed=0), SyntheticFrameStore(), **kw)


def _jax_fake(**kw):
    return _extractor(JaxFeatureExtractor, jax_make_fake_feat_fn(32, seed=0),
                      JaxSyntheticFrameStore(), **kw)


def _evaluators(tiny_arv, ex, jex, **kw):
    args = dict(eval_split="validation", r_at_n=R_AT_N, rank_chunk=7)
    args.update(kw)
    ev = ARVRetrievalTrimmed(load_trimmed_db(tiny_arv["db_path"]), _spec(tiny_arv), ex,
                             device="cpu", **args)
    jev = JaxARVRetrievalTrimmed(jax_load_trimmed_db(tiny_arv["db_path"]), tiny_arv["spec"],
                                 jex, **args)
    return ev, jev


def assert_close_tree(got, want, tol, path="result"):
    """Same keys and types; numbers within ``tol``; everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_close_tree(got[k], want[k], tol, f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, float, np.number))):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, (str, bool, type(None))):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=tol, err_msg=path)


class TestFakeFeatures:
    @pytest.mark.parametrize("eval_split", ["validation", "testing"])
    @pytest.mark.parametrize("rank_chunk,query_num", [(7, 1), (256, 1), (5, 3)])
    def test_metric_dict_matches_jax(self, tiny_arv, eval_split, rank_chunk, query_num):
        ev, jev = _evaluators(tiny_arv, _fake(), _jax_fake(), eval_split=eval_split,
                              rank_chunk=rank_chunk, query_num=query_num)
        got, want = ev.evaluation(), jev.evaluation()
        assert_close_tree(got, want, FAKE_TOL)
        assert 0.0 < got["ap"] < 0.9 and set(got["recall"]) == {"5", "10", "30"}

    def test_fake_features_equal_jax(self):
        a, b = make_fake_feat_fn(16, seed=3), jax_make_fake_feat_fn(16, seed=3)
        x = np.zeros((3, 5, 1, 1, 3), np.float32)
        for _ in range(2):  # the generator's state advances alike
            np.testing.assert_array_equal(a(x), b(x))

    def test_timings_have_no_compile_phase(self, tiny_arv):
        ev, _ = _evaluators(tiny_arv, _fake(), _jax_fake())
        ev.evaluation()
        assert set(ev.timings) == {"features", "gallery_to_device", "rank_dispatch",
                                   "metrics_readback"}
        assert all(v >= 0.0 for v in ev.timings.values())

    def test_each_chunk_is_scored_once_through_gather_scores(self, tiny_arv, monkeypatch):
        calls = []
        real = ranking.gather_scores

        def spy(q_bank, gallery, q_rows):
            calls.append(tuple(q_rows.shape))
            return real(q_bank, gallery, q_rows)

        monkeypatch.setattr(ranking, "gather_scores", spy)
        ev, _ = _evaluators(tiny_arv, _fake(), _jax_fake(), rank_chunk=7)
        ev.evaluation()
        n_queries = 6 * 3  # train + val-novel classes, three queries each
        assert calls == [(7, 1)] * -(-n_queries // 7)  # the tail chunk is padded to 7

    def test_max_batches_caps_the_gallery(self, tiny_arv):
        ev, jev = _evaluators(tiny_arv, _fake(max_batches=6), _jax_fake(max_batches=6))
        got, want = ev.evaluation(), jev.evaluation()
        assert len(ev.records) == len(jev.records) == 24
        assert_close_tree(got, want, FAKE_TOL)

    def test_no_queries_gives_the_empty_result(self, tiny_arv):
        ev, jev = _evaluators(tiny_arv, _fake(max_batches=1), _jax_fake(max_batches=1))
        for e in (ev, jev):
            e.possible_classes = set()
        assert_close_tree(ev.evaluation(), jev.evaluation(), FAKE_TOL)


def _oracle_extract(records):
    """A one-hot of the class plus a little seeded noise."""
    labels = {}
    feats = np.zeros((len(records), 32), np.float32)
    for i, r in enumerate(records):
        labels.setdefault(r.label, len(labels))
        feats[i, labels[r.label]] = 1.0
        feats[i] += np.random.default_rng(i).normal(scale=1e-3, size=32).astype(np.float32)
    return feats


class TestPerfectFeatures:
    def test_map_is_one_and_matches_jax(self, tiny_arv):
        ex, jex = _fake(), _jax_fake()
        ex.extract_trimmed = jex.extract_trimmed = _oracle_extract
        # robust_map off: the forced trailing tp would cap AP well below 1
        ev, jev = _evaluators(tiny_arv, ex, jex, robust_map=False, rank_chunk=256)
        got, want = ev.evaluation(), jev.evaluation()
        assert got["o1_class_agnostic_map"] > 0.95 and got["recall"]["30"] > 0.95
        assert_close_tree(got, want, FAKE_TOL)


class TestFeatureCache:
    NAME = "trimmed_validation_feats"

    def test_jax_cache_read_by_port(self, tiny_arv, tmp_path):
        _, jev = _evaluators(tiny_arv, _fake(), _jax_fake(cache_dir=str(tmp_path)))
        want = jev.evaluation()
        assert os.path.isdir(tmp_path / self.NAME)
        # a different seed: only the cache can give the same features
        ex = _extractor(FeatureExtractor, make_fake_feat_fn(32, seed=99), SyntheticFrameStore(),
                        cache_dir=str(tmp_path))
        ev, _ = _evaluators(tiny_arv, ex, _jax_fake(), read_cache=True)
        assert_close_tree(ev.evaluation(), want, FAKE_TOL)

    def test_port_cache_read_by_jax(self, tiny_arv, tmp_path):
        ev, _ = _evaluators(tiny_arv, _fake(cache_dir=str(tmp_path)), _jax_fake())
        got = ev.evaluation()
        np.testing.assert_array_equal(np.load(tmp_path / self.NAME / "feats.npy"),
                                      _fake().extract_trimmed(ev.records))
        jex = _extractor(JaxFeatureExtractor, jax_make_fake_feat_fn(32, seed=99),
                         JaxSyntheticFrameStore(), cache_dir=str(tmp_path))
        _, jev = _evaluators(tiny_arv, _fake(), jex, read_cache=True)
        assert_close_tree(got, jev.evaluation(), FAKE_TOL)

    def test_cache_format_roundtrip(self, tmp_path):
        ex, jex = _fake(cache_dir=str(tmp_path / "a")), _jax_fake(cache_dir=str(tmp_path / "a"))
        assert ex.load_cache("gal.npz") is None and _fake().load_cache("gal.npz") is None
        ex.save_cache("gal.npz", feats=np.arange(6.0).reshape(2, 3), hit_label=np.array(["a", "b"]))
        for reader in (ex, jex):
            out = reader.load_cache("gal.npz")
            assert set(out) == {"feats", "hit_label"}
            np.testing.assert_array_equal(out["feats"], np.arange(6.0).reshape(2, 3))
            assert list(out["hit_label"]) == ["a", "b"]
        ex.save_cache("gal.npz", feats=np.ones(3))  # overwrite: the stale key goes
        assert set(jex.load_cache("gal.npz")) == {"feats"}
        np.savez(tmp_path / "a" / "legacy.npz", feats=np.ones(2))
        np.testing.assert_array_equal(ex.load_cache("legacy.npz")["feats"], np.ones(2))


class TestDiagnostics:
    def test_cm_dict_matches_jax(self, tiny_arv):
        ev, jev = _evaluators(tiny_arv, _fake(), _jax_fake(), collect_diagnostics=True,
                              rank_chunk=7)
        got, want = ev.evaluation(), jev.evaluation()
        assert "cm_dict" in got and got["cm_dict"]["top30_result_list"]
        # the y_pred streams are raw scores, -(squared distances) of
        # magnitude ~5 from two frameworks' fp32 matmuls: 2e-5; all else 1e-6
        streams = [{k: d["cm_dict"]["system_ap_dict"].pop(k)
                    for k in list(d["cm_dict"]["system_ap_dict"]) if k.endswith("y_pred")}
                   for d in (got, want)]
        assert len(streams[0]) == 3
        assert_close_tree(streams[0], streams[1], 2e-5)
        assert_close_tree(got, want, FAKE_TOL)
        plain, _ = _evaluators(tiny_arv, _fake(), _jax_fake())
        # the per-chunk path and the whole-eval path give the same metrics
        assert_close_tree({k: v for k, v in got.items() if k != "cm_dict"},
                          plain.evaluation(), FAKE_TOL)


@pytest.fixture(scope="module")
def weights():
    v = full_model_variables(random_trunk_variables(seed=11))
    return SimpleNamespace(vars=v, trunk=trunk_from_state_dict(state_dict_from_jax(v)),
                           jmodel=SimpleNamespace(dtype=jnp.float32, bn_eps=1e-3))


def _real_extractors(weights, wire, store=None, jstore=None, **kw):
    args = dict(test_frames=2, test_batch_size=4, input_size=32, fake=False, wire=wire)
    args.update(kw)
    ex = _extractor(FeatureExtractor, make_feat_fn(weights.trunk, wire=wire, device="cpu"),
                    store or SyntheticFrameStore(), **args)
    jex = _extractor(JaxFeatureExtractor, jax_make_feat_fn(weights.jmodel, weights.vars, wire=wire),
                     jstore or JaxSyntheticFrameStore(), **args)
    return ex, jex


class TestEndToEnd:
    """The slice as a whole: DB → frame store → host pack → trunk → ranking."""

    @pytest.mark.parametrize("wire", ["rgb", "yuv420"])
    def test_features_and_metrics_match_jax(self, tiny_arv, weights, wire):
        ex, jex = _real_extractors(weights, wire, max_batches=8)
        ev, jev = _evaluators(tiny_arv, ex, jex, rank_chunk=7)
        feats, jfeats = ex.extract_trimmed(ev.records), jex.extract_trimmed(jev.records)
        assert feats.shape == jfeats.shape == (32, 512) and feats.dtype == np.float32
        np.testing.assert_allclose(feats, jfeats, rtol=0, atol=E2E_TOL)
        assert_close_tree(ev.evaluation(), jev.evaluation(), E2E_TOL)

    def test_yuv_native_store_skips_the_host_pack(self, tiny_arv, weights, tmp_path):
        from vqwild_tpu.data.frames import PackedYUV420FrameStore as JaxPackedYUV

        records = load_trimmed_db(tiny_arv["db_path"]).flat("validation")[:6]
        PackedYUV420FrameStore.pack_from_store(
            SyntheticFrameStore(h=40, w=52), str(tmp_path), subsets=("validation",),
            video_ids={"validation": [r.video_id for r in records]})
        ex, jex = _real_extractors(weights, "yuv420", PackedYUV420FrameStore(str(tmp_path)),
                                   JaxPackedYUV(str(tmp_path)))
        assert ex.yuv_native and jex.yuv_native
        jrecords = jax_load_trimmed_db(tiny_arv["db_path"]).flat("validation")[:6]
        got, want = ex.extract_trimmed(records), jex.extract_trimmed(jrecords)
        assert got.shape == (6, 512)  # a full batch and a padded one
        np.testing.assert_allclose(got, want, rtol=0, atol=E2E_TOL)

    def test_short_batch_is_padded_to_one_shape(self, weights):
        shapes = []
        fn = make_feat_fn(weights.trunk, wire="rgb", device="cpu")

        def spy(x):
            shapes.append(x.shape)
            return fn(x)

        ex = _extractor(FeatureExtractor, spy, SyntheticFrameStore(), test_frames=2,
                        test_batch_size=4, input_size=32, fake=False)
        out = ex._embed_cropped(np.zeros((3, 2, 32, 32, 3), np.uint8))
        assert out.shape == (3, 512, 2) and shapes == [(4, 2, 32, 32, 3)]

    def test_unported_and_bad_options_raise(self, weights):
        ex, _ = _real_extractors(weights, "rgb")
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ex.extract_video_tapes([])
        with pytest.raises(ValueError, match="unknown wire"):
            FeatureExtractor(None, SyntheticFrameStore(), wire="nv12")


class TestDeviceRule:
    def test_cuda_default_raises_without_gpu(self, tiny_arv):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        db = load_trimmed_db(tiny_arv["db_path"])
        with pytest.raises(RuntimeError, match="cuda"):
            ARVRetrievalTrimmed(db, _spec(tiny_arv), _fake())
