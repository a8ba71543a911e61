"""Port's exact-L2 scorer (vqwild_tpu_torch/ops/distance.py) against the JAX
package: the plain PyTorch version against pairwise_sq_l2_pallas run in
interpret mode, as tests/test_pallas.py runs it on the CPU; kernel K1
against the plain version on a GPU (marker ``cuda``).

The JAX side is imported inside the tests, so that on a machine with only
the port the ``cuda`` tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.ops import _build, distance


def _qg(nq, ng, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nq, d)).astype(np.float32),
            rng.normal(size=(ng, d)).astype(np.float32))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class TestPlainAgainstPallas:
    # the shapes and tolerance of tests/test_pallas.py (fp32 expansion,
    # summation order differs)
    @pytest.mark.parametrize("shape", [(128, 128, 512), (64, 200, 32), (300, 130, 512)])
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
        count = _build.LaunchCount()
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
    def test_library_path_follows_the_source(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
        (tmp_path / "k.cu").write_text("// one\n")
        first = _build.lib_path("k")
        (tmp_path / "k.cu").write_text("// two\n")
        assert _build.lib_path("k") != first  # an edited source rebuilds
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
    # (16, 7670, 512) is the serving shape; the others are ragged in Q, G
    # and D (D = 7 takes the kernel's scalar-load path)
    @pytest.mark.parametrize("shape", [(16, 7670, 512), (5, 130, 512), (300, 1000, 64), (3, 50, 7)])
    def test_kernel_matches_plain(self, cuda, shape):
        q, g = (torch.from_numpy(a).to(cuda) for a in _qg(*shape, seed=4))
        before = distance.launches.n
        got = distance.sq_l2(q, g)
        torch.cuda.synchronize()
        assert distance.launches.n == before + 1
        torch.testing.assert_close(got, distance.pairwise_sq_l2(q, g), rtol=1e-5, atol=1e-3)

    def test_kernel_rejects_bf16(self, cuda):
        q = torch.zeros(2, 8, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(TypeError):
            distance.sq_l2(q, q)
