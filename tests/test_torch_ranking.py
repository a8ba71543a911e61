"""Port's ranking metrics (vqwild_tpu_torch/ops/ranking.py) against the JAX
package's on the CPU: same seeded inputs through both, with planted exact
ties, ignored columns, a query with no positive, padded query rows and
padded gallery columns. Orders and counts must be equal; ``ap`` and
``recalls`` agree within 1e-6 (the sums run in a different order).

The JAX side is imported at first use, so that on a machine with only the
port the ``cuda`` tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.ops import distance, metrics_np, ranking
from vqwild_tpu_torch.retrieval.sharded import GalleryScorer, stack_query_chunks


class _Lazy:
    """A module imported when an attribute of it is first asked for."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jnp = _Lazy("jax.numpy")
jrank = _Lazy("vqwild_tpu.ops.ranking")

R_AT_N = (5, 10, 30)
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mask_case(seed, q=9, g=40):
    """Quantized scores (heavy exact ties, zeros of both signs), a query
    with no positive, one with every column but two ignored."""
    rng = np.random.default_rng(seed)
    scores = (rng.integers(-6, 6, size=(q, g)) * 0.5).astype(np.float32)
    scores[1, ::3] = -0.0
    tp = rng.random((q, g)) < 0.2
    ignore = rng.random((q, g)) < 0.15
    tp[3] = False
    ignore[4, 2:] = True
    return scores, tp, ignore


def _assert_same(got, want, keys_equal, keys_close):
    for k in keys_equal:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    for k in keys_close:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0, atol=TOL, err_msg=k)


class TestRankedRetrievalMetrics:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("robust", [True, False])
    def test_matches_jax_full_rank(self, seed, robust):
        scores, tp, ignore = _mask_case(seed)
        kw = dict(r_at_n=R_AT_N, robust=robust, topk=12, full_rank=True)
        want = jrank.ranked_retrieval_metrics(
            jnp.asarray(scores), jnp.asarray(tp), jnp.asarray(ignore), **kw)
        got = ranking.ranked_retrieval_metrics(_t(scores), _t(tp), _t(ignore), **kw)
        assert set(got) == set(want)
        _assert_same(got, want, ("top_idx", "tp_sorted", "nvalid", "npos", "scores_sorted"),
                     ("ap", "recalls"))

    @pytest.mark.parametrize("topk,full_rank", [(0, False), (7, False), (0, True)])
    def test_output_keys_follow_options(self, topk, full_rank):
        scores, tp, ignore = _mask_case(3)
        kw = dict(r_at_n=(30, 50, 100), topk=topk, full_rank=full_rank)
        want = jrank.ranked_retrieval_metrics(
            jnp.asarray(scores), jnp.asarray(tp), jnp.asarray(ignore), **kw)
        got = ranking.ranked_retrieval_metrics(_t(scores), _t(tp), _t(ignore), **kw)
        assert set(got) == set(want)
        _assert_same(got, want, [k for k in want if k not in ("ap", "recalls")],
                     ("ap", "recalls"))
        assert got["ap"].dtype == torch.float32 and got["recalls"].dtype == torch.float32

    @pytest.mark.parametrize("robust", [True, False])
    def test_ap_matches_numpy_mirror_per_query(self, robust):
        scores, tp, ignore = _mask_case(4)
        out = ranking.ranked_retrieval_metrics(_t(scores), _t(tp), _t(ignore),
                                               r_at_n=R_AT_N, robust=robust)
        for qi in range(scores.shape[0]):
            keep = ~ignore[qi]
            s, y = scores[qi][keep], tp[qi][keep]
            order = np.argsort(-s, kind="stable")
            y_true = y[order].astype(np.int64)
            if robust:
                y_true[-1] = 1
            ap = metrics_np.average_precision(y_true, s[order])
            assert abs(float(out["ap"][qi]) - ap) < 1e-5, qi
            _, rec = metrics_np.single_query_metrics(scores[qi], tp[qi], ignore[qi],
                                                     r_at_n=R_AT_N, robust=robust)
            np.testing.assert_allclose(out["recalls"][qi].numpy(), rec, atol=1e-6)

    def test_robust_quirk_changes_ap_not_recall(self):
        scores = _t(np.array([[3.0, 2.0, 1.0, 0.5]], np.float32))
        tp = _t(np.array([[True, False, False, False]]))
        ignore = _t(np.zeros((1, 4), bool))
        loose = ranking.ranked_retrieval_metrics(scores, tp, ignore, r_at_n=(2,), robust=True)
        strict = ranking.ranked_retrieval_metrics(scores, tp, ignore, r_at_n=(2,), robust=False)
        assert abs(float(loose["ap"][0]) - 0.75) < 1e-6
        assert abs(float(strict["ap"][0]) - 1.0) < 1e-6
        assert torch.equal(loose["recalls"], strict["recalls"])

    def test_stable_order_in_ties_and_ignored_tail(self):
        """Equal keys keep gallery order: inside a tie group and among the
        ignored columns (all keyed +inf), as np.argsort(kind="stable")."""
        scores = np.array([[1.0, 2.0, 1.0, 2.0, 1.0, 0.0, 2.0, 1.0]], np.float32)
        ignore = np.array([[False, True, False, False, True, False, True, False]])
        tp = np.zeros((1, 8), bool)
        out = ranking.ranked_retrieval_metrics(_t(scores), _t(tp), _t(ignore), topk=8)
        s = np.where(ignore, -np.inf, scores)
        np.testing.assert_array_equal(out["top_idx"].numpy()[0],
                                      np.argsort(-s[0], kind="stable"))
        assert out["top_idx"].numpy()[0].tolist() == [3, 0, 2, 7, 5, 1, 4, 6]


class TestApFromSorted:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        q, g = 6, 33
        nvalid = rng.integers(1, g + 1, size=(q, 1)).astype(np.int32)
        nvalid[0] = g
        valid = np.arange(g)[None, :] < nvalid
        s = -np.sort(-(rng.integers(0, 8, size=(q, g)) * 0.25).astype(np.float32), axis=1)
        s = np.where(valid, s, -np.inf).astype(np.float32)
        tp = (rng.random((q, g)) < 0.3) & valid
        tp[2] = False
        want = jrank.ap_from_sorted(jnp.asarray(s), jnp.asarray(tp), jnp.asarray(valid),
                                    jnp.asarray(nvalid))
        got = ranking.ap_from_sorted(_t(s), _t(tp), _t(valid), _t(nvalid))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
        for qi in range(q):
            k = int(nvalid[qi, 0])
            assert abs(float(got[qi]) - metrics_np.average_precision(tp[qi, :k], s[qi, :k])) < 1e-5


def _id_case(seed, g=48, d=16, b=10, query_num=2, k_src=3, pad_cols=5):
    """A gallery on a grid of quarters (every product and sum is exact in
    fp32, so both packages compute bit-equal distances), duplicated rows
    (exact ties), queries that are gallery rows, -1-padded query rows, -2
    padded source videos and -1 padded gallery columns."""
    rng = np.random.default_rng(seed)
    gallery = (rng.integers(-4, 5, size=(g, d)) / 4.0).astype(np.float32)
    gallery[10:20] = gallery[0:10]
    gal_labels = rng.integers(0, 5, size=g).astype(np.int32)
    gal_vids = np.arange(g, dtype=np.int32) // 2
    if pad_cols:
        gal_labels[-pad_cols:] = -1
        gal_vids[-pad_cols:] = -1
    n_real = g - pad_cols
    q_rows = rng.integers(0, n_real, size=(b, query_num)).astype(np.int32)
    q_rows[1, 1:] = -1  # a query with fewer source clips than query_num
    q_rows[2] = [3] * query_num  # the query IS gallery row 3 (= row 13)
    q_lab = gal_labels[q_rows[:, 0]].copy()
    q_lab[4] = 99  # a label no gallery column carries: no positive
    q_src = np.full((b, k_src), -2, np.int32)
    q_src[:, 0] = gal_vids[q_rows[:, 0]]
    q_src[::2, 1] = rng.integers(0, n_real // 2, size=len(q_src[::2]))
    return gallery, gal_labels, gal_vids, q_rows, q_lab, q_src


class TestBuildEvalMasks:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_jax(self, seed):
        _, gl, gv, _, ql, qs = _id_case(seed)
        want = jrank.build_eval_masks(*(jnp.asarray(a) for a in (gl, gv, ql, qs)))
        got = ranking.build_eval_masks(_t(gl), _t(gv), _t(ql), _t(qs))
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.bool
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        assert got[1][:, -5:].all() and not got[0][:, -5:].any()


class TestGatherScores:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_jax_bitwise_on_exact_data(self, seed):
        gallery, _, _, q_rows, _, _ = _id_case(seed)
        want = jrank.gather_scores(jnp.asarray(gallery), jnp.asarray(gallery),
                                   jnp.asarray(q_rows), False)
        got = ranking.gather_scores(_t(gallery), _t(gallery), _t(q_rows))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[2, 3] == 0.0 and got[2, 13] == 0.0  # the self row and its duplicate

    def test_scores_through_score_matrix(self, monkeypatch):
        """The distance of a chunk is ops.distance.score_matrix (kernel K1 on
        a CUDA tensor): the gathered mean reaches it contiguous and fp32."""
        seen = []
        real = distance.score_matrix

        def spy(q, g):
            seen.append((q.dtype, q.is_contiguous(), tuple(q.shape)))
            return real(q, g)

        monkeypatch.setattr(ranking, "score_matrix", spy)
        gallery, _, _, q_rows, _, _ = _id_case(0)
        ranking.gather_scores(_t(gallery), _t(gallery), _t(q_rows))
        assert seen == [(torch.float32, True, (10, 16))]

    def test_matches_jax_on_gaussian_rows(self):
        rng = np.random.default_rng(5)
        bank = rng.normal(size=(30, 32)).astype(np.float32)
        q_rows = rng.integers(0, 30, size=(7, 3)).astype(np.int32)
        q_rows[0, 2] = -1
        want = jrank.gather_scores(jnp.asarray(bank), jnp.asarray(bank), jnp.asarray(q_rows))
        got = ranking.gather_scores(_t(bank), _t(bank), _t(q_rows))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


class TestFusedChunkMetrics:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("robust", [True, False])
    def test_matches_jax_with_ties_and_padding(self, seed, robust):
        gallery, gl, gv, q_rows, ql, qs = _id_case(seed)
        kw = dict(r_at_n=R_AT_N, robust=robust, topk=20, full_rank=True)
        want = jrank.fused_chunk_metrics(
            *(jnp.asarray(a) for a in (gallery, gallery, gl, gv, q_rows, ql, qs)), **kw)
        got = ranking.fused_chunk_metrics(
            *(_t(a) for a in (gallery, gallery, gl, gv, q_rows, ql, qs)), **kw)
        assert set(got) == set(want)
        _assert_same(got, want, ("top_idx", "tp_sorted", "nvalid", "npos", "scores_sorted"),
                     ("ap", "recalls"))
        assert int(got["npos"][4]) == 0  # the query with no positive
        # every query ignores its own video (two rows) and the five pads
        assert int(got["nvalid"].max()) <= 48 - 5 - 2

    def test_self_query_ranks_self_then_duplicate(self):
        gallery, gl, gv, q_rows, ql, _ = _id_case(0)
        qs = np.full((10, 1), -2, np.int32)  # nothing ignored but the padding
        kw = dict(r_at_n=R_AT_N, topk=2)
        want = jrank.fused_chunk_metrics(
            *(jnp.asarray(a) for a in (gallery, gallery, gl, gv, q_rows, ql, qs)), **kw)
        got = ranking.fused_chunk_metrics(
            *(_t(a) for a in (gallery, gallery, gl, gv, q_rows, ql, qs)), **kw)
        np.testing.assert_array_equal(got["top_idx"].numpy(), np.asarray(want["top_idx"]))
        assert got["top_idx"][2].tolist() == [3, 13]


class TestFusedEvalMetrics:
    @pytest.mark.parametrize("robust", [True, False])
    def test_matches_jax_and_the_chunk_function(self, robust):
        gallery, gl, gv, q_rows, ql, qs = _id_case(3, b=12)
        stacked = (q_rows.reshape(3, 4, -1), ql.reshape(3, 4), qs.reshape(3, 4, -1))
        want = jrank.fused_eval_metrics(
            *(jnp.asarray(a) for a in (gallery, gallery, gl, gv) + stacked),
            r_at_n=R_AT_N, robust=robust)
        got = ranking.fused_eval_metrics(
            *(_t(a) for a in (gallery, gallery, gl, gv) + stacked),
            r_at_n=R_AT_N, robust=robust)
        assert set(got) == {"ap", "recalls"}
        assert got["ap"].shape == (3, 4) and got["recalls"].shape == (3, 4, 3)
        _assert_same(got, want, (), ("ap", "recalls"))
        whole = ranking.fused_chunk_metrics(
            *(_t(a) for a in (gallery, gallery, gl, gv, q_rows, ql, qs)),
            r_at_n=R_AT_N, robust=robust)
        np.testing.assert_array_equal(got["ap"].reshape(-1).numpy(), whole["ap"].numpy())


class TestGalleryScorerEvalState:
    def _scorer(self, seed=0):
        gallery, gl, gv, q_rows, ql, qs = _id_case(seed, pad_cols=0)
        scorer = GalleryScorer(gallery, device="cpu")
        scorer.set_columns(gl, gv)
        scorer.set_query_bank(None)
        return scorer, (gallery, gl, gv, q_rows, ql, qs)

    def test_chunk_metrics_and_eval_metrics_all_match_jax(self):
        from vqwild_tpu.retrieval.sharded import GalleryScorer as JaxScorer

        scorer, (gallery, gl, gv, q_rows, ql, qs) = self._scorer()
        jscorer = JaxScorer(gallery)
        jscorer.set_columns(gl, gv)
        jscorer.set_query_bank(None)
        kw = dict(r_at_n=R_AT_N, topk=9, full_rank=True)
        want = jscorer.chunk_metrics(q_rows, ql, qs, **kw)
        got = scorer.chunk_metrics(q_rows, ql, qs, **kw)
        _assert_same(got, want, ("top_idx", "tp_sorted", "nvalid", "npos"), ("ap", "recalls"))
        stacked = (q_rows.reshape(2, 5, -1), ql.reshape(2, 5), qs.reshape(2, 5, -1))
        want = jscorer.eval_metrics_all(*stacked, r_at_n=R_AT_N)
        got = scorer.eval_metrics_all(*stacked, r_at_n=R_AT_N)
        _assert_same(got, want, (), ("ap", "recalls"))

    def test_scores_from_bank_with_a_separate_bank(self):
        from vqwild_tpu.retrieval.sharded import GalleryScorer as JaxScorer

        scorer, (gallery, _, _, q_rows, _, _) = self._scorer(1)
        bank = gallery[::-1].copy()
        scorer.set_query_bank(bank)
        jscorer = JaxScorer(gallery)
        jscorer.set_query_bank(bank)
        np.testing.assert_array_equal(scorer.scores_from_bank(q_rows).numpy(),
                                      np.asarray(jscorer.scores_from_bank(q_rows)))
        assert scorer.q_bank.shape == (48, 16)

    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16])
    def test_scores_out_dtype_casts_on_the_device(self, out_dtype):
        """``scores(out_dtype=...)`` is the fp32 scores cast to that type,
        as the JAX scorer's ``scores(qfeats, out_dtype)``."""
        from vqwild_tpu.retrieval.sharded import GalleryScorer as JaxScorer

        scorer, (gallery, *_) = self._scorer()
        q = np.random.default_rng(4).normal(size=(5, 16)).astype(np.float32)
        full = scorer.scores(q)
        got = scorer.scores(q, out_dtype=out_dtype)
        assert full.dtype == torch.float32 and got.dtype == out_dtype
        assert torch.equal(got, full.to(out_dtype))
        want = np.asarray(JaxScorer(gallery).scores(q), np.float32)
        np.testing.assert_allclose(full.numpy(), want, rtol=1e-5, atol=1e-4)

    def test_state_must_be_set_first(self):
        scorer = GalleryScorer(np.zeros((4, 8), np.float32), device="cpu")
        with pytest.raises(AssertionError, match="set_query_bank"):
            scorer.q_bank
        scorer.set_query_bank(None)
        with pytest.raises(AssertionError, match="set_columns"):
            scorer.chunk_metrics(np.zeros((1, 1)), np.zeros(1), np.zeros((1, 1)))

    def test_pad_columns_is_identity_on_one_device(self):
        scorer, _ = self._scorer()
        tp, ig = np.zeros((2, 48), bool), np.zeros((2, 48), bool)
        out = scorer.pad_columns(tp, ig)
        assert out[0] is tp and out[1] is ig

    @pytest.mark.parametrize("qe,rank_chunk", [(10, 4), (8, 4), (3, 256)])
    def test_stack_query_chunks_matches_jax(self, qe, rank_chunk):
        from vqwild_tpu.retrieval.sharded import stack_query_chunks as jstack

        rng = np.random.default_rng(qe)
        expanded = [[int(x) for x in rng.integers(0, 50, size=rng.integers(1, 6))]
                    for _ in range(qe)]
        args = (expanded, rank_chunk, 2, 5)
        kw = dict(label_id_of=lambda i: i % 7, src_vids_of=lambda qs: [q // 2 for q in qs])
        for got, want in zip(stack_query_chunks(*args, **kw), jstack(*args, **kw)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _planted(nq, ng, d, seed):
    """Unit query and gallery rows; each of the first min(nq, ng // 30)
    queries gets 30 gallery rows at squared distances 0.02, 0.04, .., 0.6,
    well below any random row's and 0.02 apart, so its top 30 is tie-free
    (as in tests/test_torch_distance.py; kept here so that this file runs
    alone on a machine with only the port). Also returns the planted rows,
    [m, 30], nearest first."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g = rng.standard_normal((ng, d))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    m = min(nq, ng // 30)
    rows = rng.permutation(ng)[: m * 30].reshape(m, 30)
    u = rng.standard_normal((m, 30, d))
    u /= np.linalg.norm(u, axis=2, keepdims=True)
    dist = 0.02 * np.arange(1, 31)
    g[rows.reshape(-1)] = (q[:m, None] + np.sqrt(dist)[None, :, None] * u).reshape(-1, d)
    return q.astype(np.float32), g.astype(np.float32), rows


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    """fused_chunk_metrics on CUDA tensors (K1 scores the chunk) against the
    same call on the CPU, on tie-free planted data: every positive is a
    planted row, so the near-ties among the random rows, which K1's 3xTF32
    cross term may order differently from the CPU's expansion, swap
    negatives only and leave every metric where it was."""

    @pytest.mark.parametrize("g", [1000, 7670])
    def test_chunk_metrics_match_cpu(self, cuda, g):
        b = 256
        queries, gallery, rows = _planted(b, g, 512, seed=0)
        m = len(rows)
        rng = np.random.default_rng(1)
        gl = np.zeros(g, np.int32)
        gl[rows[:, ::2].reshape(-1)] = np.repeat(np.arange(1, m + 1), 15)
        gv = np.arange(g, dtype=np.int32)
        q_rows = np.arange(b, dtype=np.int32)[:, None]
        ql = np.arange(1, b + 1, dtype=np.int32)  # queries past m have no positive
        qs = rng.integers(0, g, size=(b, 2)).astype(np.int32)
        args = (queries, gallery, gl, gv, q_rows, ql, qs)
        kw = dict(r_at_n=(30, 50, 100), topk=30)
        before = distance.launches.n
        got = ranking.fused_chunk_metrics(*(_t(a).to(cuda) for a in args), **kw)
        assert distance.launches.n == before + 1
        want = ranking.fused_chunk_metrics(*(_t(a) for a in args), **kw)
        # the first m queries have 30 planted neighbours 0.02 apart
        assert m >= 33 and torch.equal(got["top_idx"][:m].cpu(), want["top_idx"][:m])
        assert torch.equal(got["npos"].cpu(), want["npos"]) and int(want["npos"][:m].min()) >= 13
        torch.testing.assert_close(got["ap"].cpu(), want["ap"], rtol=0, atol=1e-5)
        torch.testing.assert_close(got["recalls"].cpu(), want["recalls"], rtol=0, atol=1e-5)
