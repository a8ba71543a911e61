"""Port's exact-L2 scorer (vqwild_tpu_torch/ops/distance.py) against the JAX
package: the plain PyTorch version against pairwise_sq_l2_pallas run in
interpret mode, as tests/test_pallas.py runs it on the CPU; the emulation of
the kernel's three-pass TF32 split against both; kernel K1 against the
plain version on a GPU (marker ``cuda``).

The JAX side is imported inside the tests, so that on a machine with only
the port the ``cuda`` tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.ops import _build, distance


def _qg(nq, ng, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nq, d)).astype(np.float32),
            rng.normal(size=(ng, d)).astype(np.float32))


def _planted(nq, ng, d, seed):
    """Unit query and gallery rows; each of the first min(nq, ng // 30)
    queries gets 30 gallery rows at squared distances 0.02, 0.04, .., 0.6,
    well below any random row's and 0.02 apart, so its top 30 is tie-free
    (numpy copy of chip_smoke.planted)."""
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
    return q.astype(np.float32), g.astype(np.float32), m


def _top30(sq_dist):
    """Rows of the 30 best scores (−distance), lower row first on a tie, as
    serve/index.py sorts them."""
    return torch.sort(-sq_dist, dim=1, descending=True, stable=True).indices[:, :30]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the shapes and tolerance of tests/test_pallas.py (fp32 expansion,
# summation order differs)
PALLAS_SHAPES = [(128, 128, 512), (64, 200, 32), (300, 130, 512)]


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("shape", PALLAS_SHAPES)
    def test_matches_pallas_interpret(self, shape):
        jax = pytest.importorskip("jax")
        pk = pytest.importorskip("vqwild_tpu.ops.pallas_kernels")
        q, g = _qg(*shape)
        want = np.asarray(pk.pairwise_sq_l2_pallas(q, g, interpret=jax.default_backend() != "tpu"))
        got = distance.pairwise_sq_l2(torch.from_numpy(q), torch.from_numpy(g)).numpy()
        assert got.shape == shape[:2]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)

    def test_score_matrix_matches_jax(self):
        jd = pytest.importorskip("vqwild_tpu.ops.distance")
        q, g = _qg(7, 33, 16, seed=1)
        want = np.asarray(jd.score_matrix(q, g))
        got = distance.score_matrix(torch.from_numpy(q), torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)

    def test_nonnegative_and_zero_diag(self):
        x = torch.from_numpy(_qg(130, 1, 64, seed=2)[0])
        d = distance.pairwise_sq_l2(x, x).numpy()
        assert (d >= 0).all()
        np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-3)


class TestTf32Split:
    """The kernel's arithmetic (hi/lo TF32 split of q and g, three products)
    in plain PyTorch: it keeps fp32 accuracy and the plain version's order,
    and one TF32 pass does not."""

    @staticmethod
    def _pallas(q, g):
        jax = pytest.importorskip("jax")
        pk = pytest.importorskip("vqwild_tpu.ops.pallas_kernels")
        return np.asarray(pk.pairwise_sq_l2_pallas(q, g, interpret=jax.default_backend() != "tpu"))

    @pytest.mark.parametrize("shape", PALLAS_SHAPES)
    def test_three_passes_match_pallas_interpret(self, shape):
        q, g = _qg(*shape)
        got = distance.pairwise_sq_l2_tf32_emulated(torch.from_numpy(q), torch.from_numpy(g))
        assert got.shape == shape[:2] and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), self._pallas(q, g), rtol=1e-5, atol=1e-3)

    @pytest.mark.parametrize("shape", PALLAS_SHAPES)
    def test_one_pass_fails_that_tolerance(self, shape):
        """A kernel that lost the compensation would be caught by the
        tolerance the kernel is held to."""
        q, g = _qg(*shape)
        got = distance.pairwise_sq_l2_tf32_emulated(torch.from_numpy(q), torch.from_numpy(g),
                                                    passes=1)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got.numpy(), self._pallas(q, g), rtol=1e-5, atol=1e-3)

    # unit rows, the serving data: distances are <= 4, one fp32 ULP there is
    # 2.4e-7 and the expansion sums three terms of that size, so either
    # kernel stays within 2e-6 of the exact distance (the split adds ~2^-22
    # relative per product, nothing visible) and the two within 4e-6 of each
    # other; the planted distances are 0.02 apart
    @pytest.mark.parametrize("shape", [(16, 700, 512), (5, 130, 512), (40, 1300, 64)])
    def test_planted_top30_equals_the_jax_kernels(self, shape):
        q, g, m = _planted(*shape, seed=5)
        assert m >= 4
        want = self._pallas(q, g)
        got = distance.pairwise_sq_l2_tf32_emulated(torch.from_numpy(q), torch.from_numpy(g))
        exact = ((q.astype(np.float64)[:, None] - g.astype(np.float64)[None]) ** 2).sum(-1)
        np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=2e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-6)
        top_jax = np.argsort(want[:m], axis=1, kind="stable")[:, :30]
        np.testing.assert_array_equal(_top30(got[:m]).numpy(), top_jax)

    # a row and its copy, the copy in the last (partial) 32-row tile too
    @pytest.mark.parametrize("ng,src,dst", [(130, 3, 129), (130, 40, 41), (200, 0, 64)])
    def test_duplicated_rows_score_equal_and_lower_row_first(self, ng, src, dst):
        q, g, _ = _planted(4, ng, 64, seed=6)
        g[dst] = g[src]
        q[0] = g[src]
        got = distance.pairwise_sq_l2_tf32_emulated(torch.from_numpy(q), torch.from_numpy(g))
        assert torch.equal(got[:, src], got[:, dst])
        assert _top30(got)[0, :2].tolist() == [src, dst]

    def test_rejects_other_pass_counts(self):
        q = torch.zeros(2, 8)
        with pytest.raises(ValueError):
            distance.pairwise_sq_l2_tf32_emulated(q, q, passes=2)


class TestWrapper:
    def test_cpu_tensor_runs_plain_version(self):
        q, g = (torch.from_numpy(a) for a in _qg(5, 9, 12, seed=3))
        before = distance.launches.n
        torch.testing.assert_close(distance.sq_l2(q, g), distance.pairwise_sq_l2(q, g),
                                   rtol=0, atol=0)
        assert distance.launches.n == before  # no kernel launch on the CPU

    def test_other_device_raises(self):
        q = torch.empty(2, 4, device="meta")
        with pytest.raises(ValueError):
            distance.sq_l2(q, q)

    def test_launch_count_loses_no_update_across_threads(self):
        """The HTTP handler threads launch kernels concurrently."""
        count = profiling.Counter()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [count.add() for _ in range(2000)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
        assert count.n == 16 * 2000
        count.reset()
        assert count.n == 0


class TestBuild:
    @pytest.mark.parametrize("edited", ["k.cu", "k.cuh"])
    def test_library_path_follows_the_source(self, tmp_path, monkeypatch, edited):
        """An edited source, or an edited header of SRC_DIR that the source
        includes, rebuilds."""
        monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
        (tmp_path / "k.cu").write_text('#include "k.cuh"\n// one\n')
        (tmp_path / "k.cuh").write_text("// one\n")
        first = _build.lib_path("k")
        (tmp_path / edited).write_text((tmp_path / edited).read_text() + "// two\n")
        assert _build.lib_path("k") != first  # an edited source or header rebuilds
        assert first.parent == _build.BUILD_DIR and first.suffix == ".so"

    def test_missing_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        (tmp_path / "k.cu").write_text("// k\n")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(["k"])


@pytest.mark.cuda
class TestKernelOnCard:
    # (16, 7670, 512) and (1, 7670, 512) are the serving shapes; the others
    # are ragged in Q, G and D: D = 7 takes the kernel's scalar-load path,
    # Q = 17 two query blocks, G = 33 one warp and a one-row tail (and an odd
    # row length of the output), D = 520 and 1,100 a last chunk of K that is
    # half empty, G = 20,000 and 40,000 the launcher's other splits of K,
    # D = 0 no chunk at all
    SHAPES = [(16, 7670, 512), (5, 130, 512), (300, 1000, 64), (3, 50, 7), (1, 7670, 512),
              (17, 200, 512), (3, 33, 512), (4, 100, 520), (16, 20000, 512), (16, 40000, 512),
              (2, 64, 1100), (3, 5, 0)]

    @pytest.mark.parametrize("shape", SHAPES)
    def test_kernel_matches_plain(self, cuda, shape):
        q, g = (torch.from_numpy(a).to(cuda) for a in _qg(*shape, seed=4))
        before = distance.launches.n
        got = distance.sq_l2(q, g)
        torch.cuda.synchronize()
        assert distance.launches.n == before + 1
        torch.testing.assert_close(got, distance.pairwise_sq_l2(q, g), rtol=1e-5, atol=1e-3)

    # the split of K depends on the call's shape alone: enough warps to fill
    # 132 SMs, slices at least 32 wide
    @pytest.mark.parametrize("shape,split_k", [
        ((16, 100000, 512), 1), ((16, 40000, 512), 2), ((16, 20000, 512), 4),
        ((16, 7670, 512), 8), ((1, 7670, 512), 8), ((300, 1000, 64), 2), ((3, 50, 7), 1)])
    def test_launcher_splits_k_by_shape(self, cuda, shape, split_k):
        if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
            pytest.skip("the expected splits are those of a 132-SM card")
        plan = distance.launch_plan(*shape)
        assert plan["split_k"] == split_k and plan["block"] == 256
        rows_per_block = 32 * 8 // split_k
        assert plan["grid"] == [-(-shape[1] // rows_per_block), -(-shape[0] // 16)]

    @pytest.mark.parametrize("shape", [(16, 7670, 512), (5, 130, 512), (40, 1300, 64)])
    def test_kernel_keeps_the_plain_order_on_unit_rows(self, cuda, shape):
        """Three compensated passes, not one: within 2e-6 of the exact
        distance on unit rows, as the plain version is (one TF32 pass is 1e-4
        off), so within 4e-6 of the plain version, and the same top 30."""
        q, g, m = _planted(*shape, seed=5)
        q, g = torch.from_numpy(q).to(cuda), torch.from_numpy(g).to(cuda)
        got, want = distance.sq_l2(q, g), distance.pairwise_sq_l2(q, g)
        exact = torch.cdist(q.double(), g.double(), compute_mode="donot_use_mm_for_euclid_dist") ** 2
        torch.testing.assert_close(got.double(), exact, rtol=0, atol=2e-6)
        torch.testing.assert_close(got, want, rtol=0, atol=4e-6)
        assert torch.equal(_top30(got[:m]), _top30(want[:m]))

    @pytest.mark.parametrize("which", ["gallery", "queries", "both"])
    def test_kernel_takes_misaligned_pointers(self, cuda, which):
        """A contiguous view one float into its storage is not 16-byte
        aligned: the kernel's scalar-load path, same arithmetic."""
        def shifted(a):
            base = torch.empty(a.size + 1, device=cuda)
            view = base[1:].view(a.shape)
            view.copy_(torch.from_numpy(a))
            assert view.is_contiguous() and view.data_ptr() % 16 == 4
            return view

        qn, gn = _qg(5, 130, 512, seed=7)
        q = shifted(qn) if which in ("queries", "both") else torch.from_numpy(qn).to(cuda)
        g = shifted(gn) if which in ("gallery", "both") else torch.from_numpy(gn).to(cuda)
        aligned = distance.sq_l2(torch.from_numpy(qn).to(cuda), torch.from_numpy(gn).to(cuda))
        got = distance.sq_l2(q, g)
        torch.testing.assert_close(got, distance.pairwise_sq_l2(q, g), rtol=1e-5, atol=1e-3)
        assert torch.equal(got, aligned)  # the two load paths feed one arithmetic

    # a row and its copy in the last, partial 32-row tile, at each split of
    # K and on the scalar path: the stable top-k sort needs equal scores
    @pytest.mark.parametrize("shape,src,dst", [
        ((16, 7670, 512), 5, 7669), ((16, 40000, 512), 31, 39999), ((16, 100000, 512), 64, 99999),
        ((4, 130, 64), 3, 129), ((3, 50, 7), 0, 49), ((16, 20001, 512), 17, 20000)])
    def test_duplicated_rows_score_bit_equal(self, cuda, shape, src, dst):
        qn, gn = _qg(*shape, seed=8)
        gn[dst] = gn[src]
        qn[0] = gn[src]
        got = distance.sq_l2(torch.from_numpy(qn).to(cuda), torch.from_numpy(gn).to(cuda))
        assert torch.equal(got[:, src], got[:, dst])
        order = torch.sort(-got[0], descending=True, stable=True).indices
        assert order[:2].tolist() == [src, dst]

    def test_kernel_rejects_bf16(self, cuda):
        q = torch.zeros(2, 8, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(TypeError):
            distance.sq_l2(q, q)
