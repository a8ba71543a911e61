"""Kernel K4 (vqwild_tpu_torch/ops/linear.py, csrc/linear_gemm.cu): the
wrapper's dispatch and the shapes it takes, the TimeSformer trunk's choice
of K4 for its linears, the kernels' three-product TF32 split in plain
PyTorch against float64 in all three passes; on a GPU (marker ``cuda``) the
kernels at every linear geometry of the TimeSformer train step against
float64, and one train step at the benchmark's shapes against the same
step through cuBLAS.

No JAX here: the ``cuda`` tests run on a machine without it."""

import copy
import statistics

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from vqwild_tpu_torch.models import timesformer
from vqwild_tpu_torch.ops import linear as linear_ops

# Three TF32 products carry each product to ~2^-21 relative and sum in
# fp32: against float64 they read 4e-8 to 7e-7 of the reference's largest
# entry at these sizes, as plain fp32 does; one TF32 product (2^-11
# relative) reads 2.6e-4 to 3.9e-4. 5e-6 lies between, with room both ways.
SPLIT_TOL = 5e-6

# The TimeSformer train step's linears (30 clips of 8 x 224², ViT-B/16) as
# (name, M, K, N): the temporal branch's rows are the 1,568 patch tokens of
# a clip, the spatial branch's the 197 tokens of each of its 8 frames;
# every block's MLP runs again on the 30 class tokens; the patch embedding
# is a product over the patches gathered in token order.
TRUNK_GEOMETRIES = [
    ("temporal.qkv", 30 * 1568, 768, 2304),
    ("temporal.proj", 30 * 1568, 768, 768),  # also temporal_fc, the patch embedding
    ("spatial.qkv", 30 * 1576, 768, 2304),
    ("spatial.proj", 30 * 1576, 768, 768),
    ("mlp.fc1", 30 * 1568, 768, 3072),
    ("mlp.fc2", 30 * 1568, 3072, 768),
    ("cls.fc1", 30, 768, 3072),
    ("cls.fc2", 30, 3072, 768),
]
# K4's weight-gradient launches in a VA train step of the 12-block trunk:
# its 9 linears a block and the patch embedding run forward (109), less the
# last block's MLP on the class token, which feeds only the clip embedding
# that the VA loss does not read, so it has no backward
STEP_WGRADS = 12 * 9 + 1 - 2
# the same widths with M cut to run on the CPU (the class token's 30 kept)
SMALL = [(name, min(m, 64), k, n) for name, m, k, n in TRUNK_GEOMETRIES]
SMALL_IDS = [g[0] for g in SMALL]


def _case(m, k, n, scale=1.0, seed=0, device="cpu", dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    x = scale * torch.randn(m, k, generator=g, device=device)
    w = torch.randn(n, k, generator=g, device=device) * (1.0 / k) ** 0.5
    b = 0.1 * torch.randn(n, generator=g, device=device)
    gy = torch.randn(m, n, generator=g, device=device)
    return tuple(t.to(dtype) for t in (x, w, b, gy))


def _passes(fn, x, w, b, gy):
    """(y, dx, dw, db) of ``fn(x, w, b)`` with cotangent gy."""
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    y = fn(x, w, b)
    return (y.detach(),) + torch.autograd.grad(y, (x, w, b), gy)


def _rel_errs(got, want):
    return [float((a.double() - b.double()).abs().max() / b.double().abs().max())
            for a, b in zip(got, want)]


class TestDispatch:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_cpu_tensor_runs_plain_linear_exactly(self, dtype):
        x, w, b, _ = _case(2 * 3, 64, 32, dtype=dtype)
        x = x.view(2, 3, 64)
        torch.testing.assert_close(linear_ops.linear(x, w, b), F.linear(x, w, b), rtol=0, atol=0)
        torch.testing.assert_close(linear_ops.linear(x, w), F.linear(x, w), rtol=0, atol=0)

    def test_other_device_raises(self):
        x, w, b, _ = _case(4, 32, 32)
        with pytest.raises(ValueError):
            linear_ops.linear(x.to("meta"), w.to("meta"), b.to("meta"))

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_other_cpu_dtypes_raise(self, dtype):
        x, w, b, _ = _case(4, 32, 32, dtype=dtype)
        with pytest.raises(TypeError):
            linear_ops.linear(x, w, b)

    @pytest.mark.parametrize("name,m,k,n", TRUNK_GEOMETRIES, ids=[g[0] for g in TRUNK_GEOMETRIES])
    def test_takes_the_trunk_geometries(self, name, m, k, n):
        assert linear_ops.geometry((m // 30, 30, k), (n, k), (n,)) == (m // 30 * 30, n, k)

    @pytest.mark.parametrize("x_shape,w_shape,b_shape", [
        ((4, 48), (32, 48), (32,)),     # K not a multiple of 32
        ((4, 64), (40, 64), (40,)),     # N not a multiple of 32
        ((4, 64), (32, 96), (32,)),     # weight does not fit x
        ((4, 64), (32, 64, 1), None),   # weight not 2-D
        ((4, 64), (32, 64), (64,)),     # bias of another width
        ((0, 64), (32, 64), (32,)),     # no rows
    ])
    def test_rejects_shapes_the_kernels_do_not_take(self, x_shape, w_shape, b_shape):
        with pytest.raises(ValueError):
            linear_ops.geometry(x_shape, w_shape, b_shape)

    def test_rejects_32_bit_overflow(self):
        with pytest.raises(ValueError):
            linear_ops.geometry((2 ** 22, 1024), (32, 1024))

    def test_each_launch_counts_its_pass_and_its_flop(self):
        """The recorder's ``linear.*`` counters (tsf_linear_roofline.train
        reads ``linear.flop``): a launch of each pass, counted as the
        launchers count it, 2·M·N·K each."""
        from torch.profiler import ProfilerActivity, profile

        from vqwild_tpu_torch.core import profiling

        m, n, k = geo = (30 * 1568, 2304, 768)
        before = {p: linear_ops.launches[p].n for p in linear_ops.PASSES}
        with profile(activities=[ProfilerActivity.CPU]):
            for p in linear_ops.PASSES:
                linear_ops.launches.count(p, 2 * m * n * k)
        counters = profiling.counters()
        assert {p: counters.get(f"linear.{p}") for p in linear_ops.PASSES} == {
            "fwd": 1, "dgrad": 1, "wgrad": 1}
        assert counters["linear.flop"] == 3 * 2 * 47040 * 2304 * 768
        assert {p: linear_ops.launches[p].n - before[p] for p in linear_ops.PASSES} == {
            "fwd": 1, "dgrad": 1, "wgrad": 1}


class TestTrunkDispatch:
    """The trunk's linears: K4 for a CUDA float32 input, ``F.linear`` for
    every other input, with no setting."""

    @pytest.fixture()
    def no_kernel(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("K4 called off the card")
        monkeypatch.setattr(linear_ops, "linear", refuse)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16,
                                       torch.float16])
    def test_every_other_input_runs_f_linear_unchanged(self, no_kernel, dtype):
        layer = nn.Linear(64, 96).to(dtype)
        x = torch.randn(2, 5, 64).to(dtype)
        want = F.linear(x, layer.weight, layer.bias)
        torch.testing.assert_close(timesformer._linear(layer, x), want, rtol=0, atol=0)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_the_trunk_on_the_cpu_takes_the_plain_path(self, no_kernel, monkeypatch, depth):
        """Forward and backward of a small trunk on the CPU launch nothing,
        and every one of its linears (9 a block and the patch embedding)
        goes through ``_affine``."""
        calls = []
        plain = timesformer._affine

        def counted(x, weight, bias):
            calls.append((tuple(x.shape), tuple(weight.shape)))
            return plain(x, weight, bias)

        monkeypatch.setattr(timesformer, "_affine", counted)
        torch.manual_seed(3)
        trunk = timesformer.TimeSformer(64, depth=depth, heads=4, mlp=128, patch=8, frames=2,
                                        crop=16)
        before = {p: linear_ops.launches[p].n for p in linear_ops.PASSES}
        frames, clip = trunk.embed(torch.randn(3, 2, 16, 16, 3), train=True)
        (frames.sum() + clip.sum()).backward()
        assert {p: linear_ops.launches[p].n - before[p] for p in linear_ops.PASSES} == {
            "fwd": 0, "dgrad": 0, "wgrad": 0}
        assert len(calls) == 9 * depth + 1
        assert calls[0] == ((3, 4 * 2, 8 * 8 * 3), (64, 8 * 8 * 3))  # the patch embedding


class TestSplitEmulation:
    """The kernels' arithmetic (hi/lo TF32 split, three products, fp32 sums)
    in plain PyTorch, in the forward pass and both gradients: it keeps fp32
    accuracy, and one TF32 product does not."""

    @pytest.mark.parametrize("scale", [1.0, 1e3, 1e-3])
    @pytest.mark.parametrize("name,m,k,n", SMALL, ids=SMALL_IDS)
    def test_three_products_match_float64(self, name, m, k, n, scale):
        x, w, b, gy = _case(m, k, n, scale=scale, seed=1)
        got = _passes(linear_ops.linear_tf32_emulated, x, w, b, gy)
        want = _passes(F.linear, x.double(), w.double(), b.double(), gy.double())
        assert [t.shape for t in got] == [t.shape for t in want]
        for what, err in zip(("fwd", "dgrad", "wgrad", "bias"), _rel_errs(got, want)):
            assert err < SPLIT_TOL, (what, err)

    @pytest.mark.parametrize("scale", [1.0, 1e3])
    @pytest.mark.parametrize("name,m,k,n", SMALL, ids=SMALL_IDS)
    def test_one_product_does_not_match_float64(self, name, m, k, n, scale):
        x, w, b, gy = _case(m, k, n, scale=scale, seed=1)
        got = _passes(lambda *a: linear_ops.linear_tf32_emulated(*a, passes=1), x, w, b, gy)
        want = _passes(F.linear, x.double(), w.double(), b.double(), gy.double())
        for what, err in zip(linear_ops.PASSES, _rel_errs(got[:3], want[:3])):
            assert err > 10 * SPLIT_TOL, (what, err)

    @pytest.mark.parametrize("bias", [True, False])
    def test_its_autograd_is_f_linear_s_in_float64(self, bias):
        """Over batched rows [B, L, K], with and without a bias: the same
        gradients, in shape and within SPLIT_TOL, as ``F.linear``'s autograd
        in float64."""
        x, w, b, gy = _case(2 * 24, 96, 64, seed=2)
        x, gy = x.view(2, 24, 96), gy.view(2, 24, 64)
        b = b if bias else None
        leaves = (x, w) + ((b,) if bias else ())
        got_in = [t.detach().requires_grad_() for t in leaves]
        want_in = [t.double().detach().requires_grad_() for t in leaves]
        y = linear_ops.linear_tf32_emulated(*got_in)
        y64 = F.linear(*want_in)
        got = (y.detach(),) + torch.autograd.grad(y, got_in, gy)
        want = (y64.detach(),) + torch.autograd.grad(y64, want_in, gy.double())
        assert [t.shape for t in got] == [t.shape for t in want]
        assert all(t.dtype == torch.float32 for t in got)
        for err in _rel_errs(got, want):
            assert err < SPLIT_TOL

    def test_rejects_other_product_counts(self):
        x, w, b, _ = _case(4, 32, 32)
        with pytest.raises(ValueError):
            linear_ops.linear_tf32_emulated(x, w, b, passes=2)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K4 runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K4 against float64 on the card, as a share of the reference's largest
# entry, in every pass: the three products are good to ~2^-21 and each
# 32-deep tile's products go into a fresh accumulator, summed in fp32 over
# K (forward: up to 3,072; input gradient: over N, up to 3,072) and over M
# for the weight gradient (47,280 rows, summed in splits, then the splits
# in order). The CPU emulation reads 4e-8 to 7e-7 at these widths, one
# TF32 product 2.6e-4 to 3.9e-4; 5e-6 lies between, as K3's limit.
CARD_TOL = {"fwd": 5e-6, "dgrad": 5e-6, "wgrad": 5e-6, "bias": 5e-6}


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("name,m,k,n", TRUNK_GEOMETRIES,
                             ids=[g[0] for g in TRUNK_GEOMETRIES])
    def test_three_passes_match_float64(self, cuda, name, m, k, n):
        x, w, b, gy = _case(m, k, n, seed=m + n, device=cuda)
        before = {p: linear_ops.launches[p].n for p in linear_ops.PASSES}
        got = _passes(linear_ops.linear, x, w, b, gy)
        torch.cuda.synchronize()
        assert {p: linear_ops.launches[p].n - before[p] for p in linear_ops.PASSES} == {
            "fwd": 1, "dgrad": 1, "wgrad": 1}
        want = _passes(F.linear, x.double(), w.double(), b.double(), gy.double())
        for what, err in zip(CARD_TOL, _rel_errs(got, want)):
            assert err < CARD_TOL[what], (name, what, err)

    def test_weight_gradient_repeats_bit_for_bit(self, cuda):
        x, w, b, gy = _case(30 * 1576, 768, 768, seed=5, device=cuda)
        first = _passes(linear_ops.linear, x, w, b, gy)
        second = _passes(linear_ops.linear, x, w, b, gy)
        for a, c in zip(first, second):
            assert torch.equal(a, c)

    def test_a_strided_input_is_made_contiguous_once(self, cuda):
        x, w, b, gy = _case(4 * 96, 64, 32, seed=6, device=cuda)
        xt = x.view(4, 96, 64).transpose(0, 1)  # [96, 4, 64], not contiguous
        before = linear_ops.relayouts.n
        got = _passes(linear_ops.linear, xt, w, b, gy.view(96, 4, 32))
        torch.cuda.synchronize()
        assert linear_ops.relayouts.n == before + 1  # the input; the gradient arrives whole
        want = _passes(linear_ops.linear, xt.contiguous(), w, b, gy.view(96, 4, 32))
        for a, c in zip(got, want):
            torch.testing.assert_close(a, c, rtol=0, atol=0)

    def test_card_rejects_what_the_kernels_do_not_take(self, cuda):
        for dtype in (torch.bfloat16, torch.float16, torch.float64):
            with pytest.raises(TypeError):
                linear_ops.linear(torch.zeros(4, 32, device=cuda, dtype=dtype),
                                  torch.zeros(32, 32, device=cuda, dtype=dtype))
        with pytest.raises(ValueError):
            linear_ops.linear(torch.zeros(4, 48, device=cuda), torch.zeros(32, 48, device=cuda))
        with pytest.raises(ValueError):
            linear_ops.linear(torch.zeros(4, 32, device=cuda), torch.zeros(40, 32, device=cuda))

    def test_tsf_train_step_matches_cublas_within_the_benchmark_limits(self, cuda, monkeypatch):
        """One fp32 va train step of the TimeSformer trunk at the benchmark's
        shapes (10 triplets of 8 x 224² on the yuv420 wire), its linears on
        K4, against the same step from the same state with every linear
        through cuBLAS fp32: the loss and the worst leaf's gradient (Adam's
        first moment, as the benchmark reads it) within the limits
        ``correct`` holds a run to (portbench/workloads/tsf-va-train.json:
        5e-7, 2e-3)."""
        import numpy as np

        from vqwild_tpu_torch.models.arv import ARVModel
        from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
        from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, \
            make_train_step

        rng = np.random.default_rng(22)
        clips = rng.integers(0, 256, (30, 8, 224, 224, 3), dtype=np.uint8)
        labels = torch.from_numpy(rng.integers(0, 200, 30)).to(cuda)
        arrays = tuple(torch.from_numpy(a).to(cuda) for a in rgb_to_yuv420_host(clips))
        torch.manual_seed(4)
        with cuda:
            base = ARVModel("va", nclass=200, feat_dim=768, trunk="timesformer_divst")
        g = torch.Generator(device=cuda).manual_seed(5)
        with torch.no_grad():  # temporal_fc starts at zero past block 0: give it a gradient path
            for blk in base.blocks:
                blk.temporal_fc.weight.normal_(0.0, 0.02, generator=g)
        runs = {}
        for name in ("k4", "cublas"):
            model = copy.deepcopy(base)
            if name == "cublas":
                monkeypatch.setattr(linear_ops, "linear", linear_ops.linear_plain)
            tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100,
                                lr_decay_epoch=9)
            state = create_train_state(model, tx, seed=2)
            before = linear_ops.launches["wgrad"].n
            state, losses = make_train_step(model, tx, wire="yuv420")(state, *arrays, labels)
            torch.cuda.synchronize()
            assert linear_ops.launches["wgrad"].n - before == (STEP_WGRADS if name == "k4" else 0)
            grads = {k: float((state.optimizer.state[p]["exp_avg"] / 0.1).double().norm())
                     for k, p in model.named_parameters() if p in state.optimizer.state}
            runs[name] = (float(losses["loss"]), grads)
            del model, state
            torch.cuda.empty_cache()
        (loss, grads), (ref_loss, ref_grads) = runs["k4"], runs["cublas"]
        assert abs(loss - ref_loss) / abs(ref_loss) < 5e-7
        med = statistics.median(ref_grads.values())
        moved = [k for k, v in ref_grads.items() if v >= 1e-3 * med]
        gap = max(abs(grads[k] - ref_grads[k]) / max(ref_grads[k], med) for k in moved)
        assert gap < 2e-3
