"""Port's fused stem (vqwild_tpu_torch/ops/stem_pool.py) against the JAX
package: the plain PyTorch version against stem_s2d_pool_pallas run in
interpret mode, as tests/test_pallas.py runs it on the CPU; the emulation of
the fp32 kernel's three-pass TF32 split against both; kernel K2 against the
plain version on a GPU (marker ``cuda``)."""

import numpy as np
import pytest
import torch

from vqwild_tpu_torch.ops import stem_pool, tf32

# fp32: the same conv sums in another order (1e-5, test_pallas.py's);
# bf16: accumulation order can move the final bf16 rounding by one ULP
# (≈0.016 at magnitude 2), as tests/test_pallas.py states
TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _inputs(n, hw, seed, c=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, c)).astype(np.float32)
    k = (0.1 * rng.standard_normal((4, 4, c, 64))).astype(np.float32)
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


class TestTf32Split:
    """The fp32 kernel's arithmetic (hi/lo TF32 split, three products) in
    plain PyTorch: it keeps fp32 accuracy, and one TF32 pass does not."""

    # |conv| ~ scale (x ~ N(0, scale), w ~ 0.1, K = 96); the dropped lo*lo term
    # and the split's rounding are ~2^-21 relative, so 2e-5 * scale holds with
    # room, while one TF32 pass (2^-11 relative per product) is ~30x above it
    SPLIT_TOL = 2e-5

    def test_rounding_is_to_nearest_ties_away(self):
        v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                          1.0 + 2.0 ** -10 + 2.0 ** -11, 3.0e-20, -7.25],
                         dtype=torch.float32)
        want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                             1.0 + 2.0 ** -9, 3.0e-20, -7.25], dtype=torch.float32)
        got = tf32.tf32_round(v)
        assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
        torch.testing.assert_close(got[:4], want[:4], rtol=0, atol=0)
        torch.testing.assert_close(got[4:], want[4:], rtol=2.0 ** -11, atol=0)

    def test_split_sum_is_the_three_products_in_their_order(self):
        """``tf32.split_sum``, which every kernel's emulation takes: with
        ``passes=3`` the products (lo·hi + hi·lo) + hi·hi bit for bit, with
        ``passes=1`` hi·hi, and no other pass count."""
        gen = torch.Generator().manual_seed(5)
        a = torch.randn(24, 96, generator=gen) * 1e3
        b = torch.randn(40, 96, generator=gen)

        def fn(u, v):
            return u @ v.T

        (a_hi, a_lo), (b_hi, b_lo) = tf32.tf32_split(a), tf32.tf32_split(b)
        want = (fn(a_lo, b_hi) + fn(a_hi, b_lo)) + fn(a_hi, b_hi)
        assert torch.equal(tf32.split_sum(fn, a, b, passes=3), want)
        assert torch.equal(tf32.split_sum(fn, a, b, passes=1), fn(a_hi, b_hi))
        for passes in (0, 2, 4):
            with pytest.raises(ValueError, match="passes must be 1 or 3"):
                tf32.split_sum(fn, a, b, passes)

    @pytest.mark.parametrize("scale", [1.0, 1e3, 1e-3])
    @pytest.mark.parametrize("n,hw", [(5, 16), (4, 12)])
    def test_three_passes_match_plain(self, n, hw, scale):
        x, k, b = _inputs(n, hw, seed=7)
        args = _torch(x * np.float32(scale), k, b * np.float32(scale), torch.float32)
        want = stem_pool.stem_s2d_pool_plain(*args)
        got = stem_pool.stem_s2d_pool_tf32_emulated(*args)
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=self.SPLIT_TOL * scale)

    @pytest.mark.parametrize("scale", [1.0, 1e3, 1e-3])
    @pytest.mark.parametrize("n,hw", [(5, 16), (4, 12)])
    def test_one_pass_does_not_match_plain(self, n, hw, scale):
        x, k, b = _inputs(n, hw, seed=7)
        args = _torch(x * np.float32(scale), k, b * np.float32(scale), torch.float32)
        want = stem_pool.stem_s2d_pool_plain(*args)
        got = stem_pool.stem_s2d_pool_tf32_emulated(*args, passes=1)
        assert (got - want).abs().max().item() > 5 * self.SPLIT_TOL * scale

    @pytest.mark.parametrize("n,hw", [(5, 16), (4, 12)])
    def test_three_passes_match_pallas_interpret(self, n, hw):
        jax = pytest.importorskip("jax")
        jnp = jax.numpy
        pk = pytest.importorskip("vqwild_tpu.ops.pallas_kernels")
        x, k, b = _inputs(n, hw, seed=2)
        want = pk.stem_s2d_pool_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                       interpret=jax.default_backend() != "tpu")
        got = stem_pool.stem_s2d_pool_tf32_emulated(*_torch(x, k, b, torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=TOL["float32"])

    def test_rejects_other_pass_counts(self):
        with pytest.raises(ValueError):
            stem_pool.stem_s2d_pool_tf32_emulated(
                *_torch(*_inputs(1, 4, seed=1), torch.float32), passes=2)


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

    # a clip query's 32 frames (fewer work items than two per SM), an odd C
    # (the staged tile pads channels to even; plain loads, no cp.async), and
    # C = 2, the narrowest K
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,hw,c", [(32, 56, 6), (3, 20, 3), (2, 14, 1), (2, 10, 2)])
    def test_kernel_matches_plain_other_batches_and_channels(self, cuda, n, hw, c, dtype):
        args = [t.to(cuda) for t in _torch(*_inputs(n, hw, seed=8, c=c), getattr(torch, dtype))]
        got = stem_pool.stem_s2d_pool(*args)
        torch.cuda.synchronize()
        want = stem_pool.stem_s2d_pool_plain(*args)
        atol = 2e-5 if dtype == "float32" else TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)

    def test_kernel_keeps_fp32_accuracy_on_scaled_inputs(self, cuda):
        """Three compensated TF32 passes, not one: 2e-5 relative at x ~ 1e3."""
        x, k, b = _inputs(3, 56, seed=9)
        args = [t.to(cuda) for t in _torch(x * np.float32(1e3), k, b, torch.float32)]
        got = stem_pool.stem_s2d_pool(*args)
        want = stem_pool.stem_s2d_pool_plain(*args)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * 1e3)

    def test_kernel_rejects_odd_size(self, cuda):
        x = torch.zeros(1, 5, 4, 6, device=cuda)
        with pytest.raises(ValueError):
            stem_pool.stem_s2d_pool(x, torch.zeros(96, 64, device=cuda),
                                    torch.zeros(64, device=cuda))
