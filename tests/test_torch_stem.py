"""Port's fused stem (vqwild_tpu_torch/ops/stem_pool.py) against the JAX
package: the plain PyTorch version against stem_s2d_pool_pallas run in
interpret mode, as tests/test_pallas.py runs it on the CPU; kernel K2
against the plain version on a GPU (marker ``cuda``)."""

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.ops import stem_pool

# fp32: the same conv sums in another order (1e-5, test_pallas.py's);
# bf16: accumulation order can move the final bf16 rounding by one ULP
# (≈0.016 at magnitude 2), as tests/test_pallas.py states
TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _inputs(n, hw, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 6)).astype(np.float32)
    k = (0.1 * rng.standard_normal((4, 4, 6, 64))).astype(np.float32)
    b = (0.1 * rng.standard_normal((64,))).astype(np.float32)
    return x, k, b


def _torch(x, k, b, dtype):
    return (torch.from_numpy(x).to(dtype),
            torch.from_numpy(k.reshape(-1, 64)).to(dtype),
            torch.from_numpy(b).to(dtype))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K2 runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class TestPlainAgainstPallas:
    # n=5 exercises the Pallas wrapper's frame padding; 16x16 and 12x12 are
    # the test-crop feeds of tests/test_pallas.py
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,hw", [(5, 16), (4, 12)])
    def test_matches_pallas_interpret(self, n, hw, dtype):
        jax = pytest.importorskip("jax")
        jnp = jax.numpy
        pk = pytest.importorskip("vqwild_tpu.ops.pallas_kernels")
        x, k, b = _inputs(n, hw, seed=2)
        jdt = jnp.dtype(dtype)
        want = pk.stem_s2d_pool_pallas(
            jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt), jnp.asarray(b).astype(jdt),
            interpret=jax.default_backend() != "tpu",
        )
        got = stem_pool.stem_s2d_pool_plain(*_torch(x, k, b, getattr(torch, dtype)))
        assert tuple(got.shape) == (n, hw // 2, hw // 2, 64)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=TOL[dtype])

    def test_matches_folded_trunk_stem_block(self):
        """The stem block of ResNet18F2FInfer(stem_mode="yuv_s2d") in the JAX
        package: conv pad ((2,1),(2,1)) + bias + ReLU + 3x3/2 maxpool."""
        jax = pytest.importorskip("jax")
        nn = pytest.importorskip("flax.linen")
        x, k, b = _inputs(3, 12, seed=5)
        y = jax.lax.conv_general_dilated(
            x, k, (1, 1), ((2, 1), (2, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + b
        want = nn.max_pool(jax.nn.relu(y), (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
        got = stem_pool.stem_s2d_pool(*_torch(x, k, b, torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


class TestWrapper:
    def test_cpu_tensor_runs_plain_version(self):
        args = _torch(*_inputs(2, 8, seed=3), torch.float32)
        before = stem_pool.launches.n
        torch.testing.assert_close(stem_pool.stem_s2d_pool(*args),
                                   stem_pool.stem_s2d_pool_plain(*args), rtol=0, atol=0)
        assert stem_pool.launches.n == before

    def test_other_device_raises(self):
        x = torch.empty(1, 4, 4, 6, device="meta")
        with pytest.raises(ValueError):
            stem_pool.stem_s2d_pool(x, torch.empty(96, 64, device="meta"),
                                    torch.empty(64, device="meta"))

    def test_output_is_channels_last_for_layers(self):
        """permute(0,3,1,2) of the NHWC output is the channels_last NCHW
        tensor layers 1-4 take, without a copy."""
        out = stem_pool.stem_s2d_pool(*_torch(*_inputs(2, 8, seed=4), torch.float32))
        assert out.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,hw", [(5, 16), (4, 12), (3, 56), (2, 130)])
    def test_kernel_matches_plain(self, cuda, n, hw, dtype):
        args = [t.to(cuda) for t in _torch(*_inputs(n, hw, seed=6), getattr(torch, dtype))]
        before = stem_pool.launches.n
        got = stem_pool.stem_s2d_pool(*args)
        torch.cuda.synchronize()
        assert stem_pool.launches.n == before + 1
        want = stem_pool.stem_s2d_pool_plain(*args)
        atol = 1e-4 if dtype == "float32" else TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)

    def test_kernel_rejects_odd_size(self, cuda):
        x = torch.zeros(1, 5, 4, 6, device=cuda)
        with pytest.raises(ValueError):
            stem_pool.stem_s2d_pool(x, torch.zeros(96, 64, device=cuda),
                                    torch.zeros(64, device=cuda))
