"""Kernel K3 (vqwild_tpu_torch/ops/conv.py, csrc/conv_igemm.cu): the
wrapper's dispatch and the shapes it takes, the kernels' three-pass TF32
split in plain PyTorch against a float64 conv in all three passes, the
trunk's choice of K3 for its block convs; on a GPU (marker ``cuda``) the
kernels at every block-conv shape of the train step against a float64
conv, and one train step against the same step through cuDNN.

No JAX here: the ``cuda`` tests run on a machine without it."""

import copy
import statistics

import pytest
import torch
import torch.nn.functional as F

from vqwild_tpu_torch.models.resnet_f2f import BasicBlock, Conv2dF2F, ResNet18F2F, \
    block_convs
from vqwild_tpu_torch.ops import conv
from vqwild_tpu_torch.ops.tf32 import tf32_split

# Three TF32 passes carry each product to ~2^-21 relative and sum in fp32:
# against a float64 conv they read 1e-7 to 7e-7 of the reference's largest
# entry at these sizes, as plain fp32 does; one TF32 pass (2^-11 relative
# per product) reads 2e-4 to 5e-4. 5e-6 lies between, with room both ways.
SPLIT_TOL = 5e-6

# (N, C, H, Cout, kernel, stride, padding): both strides, both kernel sizes,
# an odd size (the stride-2 parity classes of unequal size), the padding
SMALL = [(2, 32, 9, 64, 3, 1, 1), (2, 64, 9, 32, 3, 2, 1), (2, 32, 8, 64, 1, 2, 0),
         (3, 64, 7, 64, 3, 2, 1), (2, 32, 6, 32, 3, 1, 0)]


def _case(n, c, h, k, r, stride, padding, scale=1.0, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = (scale * torch.randn(n, c, h, h, generator=g)).to(dtype)
    w = (torch.randn(k, c, 1, r, r, generator=g) * (2.0 / (k * r * r)) ** 0.5).to(dtype)
    p, q = conv.out_size(h, h, r, stride, padding)
    gy = torch.randn(n, k, p, q, generator=g).to(dtype)
    return x, w, gy


def _passes(fn, x, w, gy):
    """(y, dx, dw) of ``fn(x, w)`` with cotangent gy."""
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    y = fn(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), gy)
    return y.detach(), dx, dw


def _rel_errs(got, want):
    return [float((a.double() - b.double()).abs().max() / b.double().abs().max())
            for a, b in zip(got, want)]


class TestDispatch:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_cpu_tensor_runs_plain_conv_exactly(self, dtype):
        n, c, h, k, r, s, p = SMALL[1]
        x, w, gy = _case(n, c, h, k, r, s, p, dtype=dtype)
        before = {name: conv.launches[name].n for name in conv.PASSES}
        got = _passes(lambda a, b: conv.conv2d(a, b, s, p), x, w, gy)
        want = _passes(lambda a, b: F.conv2d(a, b[:, :, 0], stride=s, padding=p), x, w, gy)
        for a, b in zip(got, want):
            assert a.dtype == dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert {name: conv.launches[name].n for name in conv.PASSES} == before

    def test_plain_version_takes_four_and_five_dim_weights(self):
        x, w, _ = _case(*SMALL[0])
        torch.testing.assert_close(conv.conv2d_plain(x, w, 1, 1),
                                   conv.conv2d_plain(x, w[:, :, 0], 1, 1), rtol=0, atol=0)

    def test_other_device_raises(self):
        x = torch.empty(1, 32, 4, 4, device="meta")
        with pytest.raises(ValueError):
            conv.conv2d(x, torch.empty(32, 32, 1, 3, 3, device="meta"), 1, 1)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_other_cpu_dtypes_raise(self, dtype):
        x = torch.zeros(1, 32, 4, 4, dtype=dtype)
        with pytest.raises(TypeError):
            conv.conv2d(x, torch.zeros(32, 32, 1, 3, 3, dtype=dtype), 1, 1)


class TestGeometry:
    @pytest.mark.parametrize("case", SMALL)
    def test_takes_the_block_geometries(self, case):
        n, c, h, k, r, s, p = case
        assert conv.geometry((n, c, h, h), (k, c, 1, r, r), s, p) == (n, h, h, c, k, r)
        assert conv.takes((k, c, 1, r, r), s, p)

    @pytest.mark.parametrize("x_shape,w_shape,stride,padding", [
        ((1, 3, 16, 16), (64, 3, 1, 7, 7), 2, 3),     # the stem: 3 channels, 7x7
        ((1, 48, 8, 8), (64, 48, 1, 3, 3), 1, 1),     # channels not a multiple of 32
        ((1, 64, 8, 8), (40, 64, 1, 3, 3), 1, 1),     # output channels likewise
        ((1, 64, 8, 8), (64, 64, 1, 5, 5), 1, 2),     # a kernel over 3x3
        ((1, 64, 8, 8), (64, 64, 1, 3, 3), 3, 1),     # stride 3
        ((1, 64, 8, 8), (64, 64, 1, 3, 3), 1, 3),     # padding as wide as the kernel
        ((1, 64, 8, 8), (64, 64, 1, 3, 2), 1, 1),     # not square
        ((1, 64, 8, 8), (64, 32, 1, 3, 3), 1, 1),     # weight's channels do not fit x
        ((64, 8, 8), (64, 64, 1, 3, 3), 1, 1),        # x not [N,C,H,W]
        ((1, 64, 2, 2), (64, 64, 1, 3, 3), 1, 0),     # an empty output
        ((0, 64, 8, 8), (64, 64, 1, 3, 3), 1, 1),     # no image
    ])
    def test_rejects_shapes_the_kernels_do_not_take(self, x_shape, w_shape, stride, padding):
        with pytest.raises(ValueError):
            conv.geometry(x_shape, w_shape, stride, padding)

    def test_rejects_32_bit_overflow(self):
        with pytest.raises(ValueError):
            conv.geometry((2 ** 16, 64, 256, 256), (64, 64, 1, 3, 3), 1, 1)

    def test_stem_is_not_taken(self):
        assert not conv.takes((64, 3, 1, 7, 7), 2, 3)


class TestTf32Split:
    """The kernels' arithmetic (hi/lo TF32 split, three products, fp32 sums)
    in plain PyTorch, in the forward pass and both gradients: it keeps fp32
    accuracy, and one TF32 pass does not."""

    @pytest.mark.parametrize("scale", [1.0, 1e3, 1e-3])
    @pytest.mark.parametrize("case", SMALL)
    def test_three_passes_match_float64(self, case, scale):
        x, w, gy = _case(*case, scale=scale, seed=1)
        n, c, h, k, r, s, p = case
        got = _passes(lambda a, b: conv.conv_tf32_emulated(a, b, s, p), x, w, gy)
        want = _passes(lambda a, b: F.conv2d(a, b[:, :, 0], stride=s, padding=p),
                       x.double(), w.double(), gy.double())
        assert [t.shape for t in got] == [t.shape for t in want]
        for name, err in zip(conv.PASSES, _rel_errs(got, want)):
            assert err < SPLIT_TOL, (name, err)

    @pytest.mark.parametrize("scale", [1.0, 1e3])
    @pytest.mark.parametrize("case", SMALL)
    def test_one_pass_does_not_match_float64(self, case, scale):
        x, w, gy = _case(*case, scale=scale, seed=1)
        n, c, h, k, r, s, p = case
        got = _passes(lambda a, b: conv.conv_tf32_emulated(a, b, s, p, passes=1), x, w, gy)
        want = _passes(lambda a, b: F.conv2d(a, b[:, :, 0], stride=s, padding=p),
                       x.double(), w.double(), gy.double())
        for name, err in zip(conv.PASSES, _rel_errs(got, want)):
            assert err > 10 * SPLIT_TOL, (name, err)

    def test_rejects_other_pass_counts(self):
        x, w, _ = _case(*SMALL[0])
        with pytest.raises(ValueError):
            conv.conv_tf32_emulated(x, w, 1, 1, passes=2)


class TestTrunkChoice:
    def test_block_convs_take_k3_and_the_stem_does_not(self):
        trunk = ResNet18F2F()
        on = {name: conv.takes(m.weight.shape, m.stride, m.padding)
              for name, m in trunk.named_modules() if isinstance(m, Conv2dF2F)}
        assert on.pop("conv1") is False
        assert len(on) == 19 and all(on.values())
        assert sorted(on) == sorted(name for name, _, _ in block_convs(trunk, 960, 112))

    def test_block_conv_shapes_are_what_the_trunk_runs(self):
        """``block_convs``' run on the meta device lists what the trunk
        runs on real frames: 16 3x3 convs and three 1x1/2 downsamples."""
        trunk = ResNet18F2F()
        seen = []
        hooks = [m.register_forward_hook(
            lambda mod, inp, out, name=name: seen.append(
                (name, tuple(inp[0].shape), (mod.weight.shape[0], mod.weight.shape[-1],
                                             mod.stride, mod.padding))))
            for name, m in trunk.named_modules() if isinstance(m, Conv2dF2F) and name != "conv1"]
        with torch.no_grad():
            trunk(torch.zeros(1, 2, 112, 112, 3))
        for h in hooks:
            h.remove()
        listed = block_convs(trunk, 2, 112)
        assert seen == listed
        assert sorted(k for _, _, (_, k, _, _) in listed) == [1] * 3 + [3] * 16
        assert [s for _, _, (_, k, s, _) in listed if k == 1] == [2, 2, 2]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_block_on_the_cpu_runs_plain_conv(self, dtype):
        block = BasicBlock(32, 64, stride=2).to(dtype)
        x = torch.randn(2, 32, 9, 9, dtype=dtype)
        before = {name: conv.launches[name].n for name in conv.PASSES}
        y = block(x, train=True)
        y.sum().backward()
        assert y.dtype == dtype
        assert {name: conv.launches[name].n for name in conv.PASSES} == before
        want = F.conv2d(x, block.conv1.weight[:, :, 0], stride=2, padding=1)
        torch.testing.assert_close(block.conv1(x), want, rtol=0, atol=0)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K3 runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K3 against a float64 conv on the card, as a share of the reference's
# largest entry, in every pass: the three-pass products are good to ~2^-21
# and the fp32 sums run over K = 9C (forward, input gradient; up to 4,608)
# and over the pixels (weight gradient: up to 752,640 in layer1, summed in
# splits, then the splits in order). On an H100 the kernels read 3.0e-7
# to 6.9e-7 at these shapes; at 960 frames a pass that drops one
# correction product reads 1.8e-4 to 2.5e-4, and one TF32 pass 2.5e-4 to
# 4.1e-4 (test_planted_faults_exceed_the_tolerance, at layer1's, layer4's
# and layer2's downsample's geometry)
CARD_TOL = {"fwd": 5e-6, "dgrad": 5e-6, "wgrad": 5e-6}

# the distinct geometries of the trunk's 19 block convs
BLOCK_GEOMETRIES = sorted({(c, h, k, r, s, p) for _, (_, c, h, _), (k, r, s, p)
                           in block_convs(ResNet18F2F(), 1, 112)})


def _card_case(dev, frames, geo, seed):
    c, h, k, r, s, p = geo
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(frames, c, h, h, generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(k, c, 1, r, r, generator=g, device=dev) * (2.0 / (k * r * r)) ** 0.5
    pp, q = conv.out_size(h, h, r, s, p)
    gy = torch.randn(frames, k, pp, q, generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    return x, w, gy


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("frames", [960, 3])
    @pytest.mark.parametrize("geo", BLOCK_GEOMETRIES)
    def test_three_passes_match_float64(self, cuda, geo, frames):
        c, h, k, r, s, p = geo
        x, w, gy = _card_case(cuda, frames, geo, seed=frames)
        before = {name: conv.launches[name].n for name in conv.PASSES}
        got = _passes(lambda a, b: conv.conv2d(a, b, s, p), x, w, gy)
        torch.cuda.synchronize()
        assert {name: conv.launches[name].n - before[name] for name in conv.PASSES} == {
            "fwd": 1, "dgrad": 1, "wgrad": 1}
        assert got[0].is_contiguous(memory_format=torch.channels_last)
        assert got[1].is_contiguous(memory_format=torch.channels_last)
        want = _passes(lambda a, b: F.conv2d(a, b[:, :, 0], stride=s, padding=p),
                       x.double(), w.double(), gy.double())
        for name, err in zip(conv.PASSES, _rel_errs(got, want)):
            assert err < CARD_TOL[name], (name, err)

    @pytest.mark.parametrize("drop", ["lo*hi", "hi*lo", "both"])
    def test_planted_faults_exceed_the_tolerance(self, cuda, drop):
        """The split sum with one correction product left out, or both (one
        TF32 pass), in float64 on the TF32 parts, at layer1's geometry and
        the step's 960 frames: each pass reads well above CARD_TOL."""
        geo = (64, 28, 64, 3, 1, 1)
        c, h, k, r, s, p = geo
        x, w, gy = _card_case(cuda, 960, geo, seed=7)
        w4 = w[:, :, 0]
        fns = {"fwd": (lambda a, b: F.conv2d(a, b, stride=s, padding=p), x, w4),
               "dgrad": (lambda a, b: torch.nn.grad.conv2d_input(
                   x.shape, b, a, stride=s, padding=p), gy, w4),
               "wgrad": (lambda a, b: torch.nn.grad.conv2d_weight(
                   b, w4.shape, a, stride=s, padding=p), gy, x)}
        for name, (fn, a, b) in fns.items():
            (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a), tf32_split(b)
            terms = [(a_hi, b_hi)] + [t for t, d in (((a_lo, b_hi), "lo*hi"),
                                                     ((a_hi, b_lo), "hi*lo"))
                                      if drop not in (d, "both")]
            got = sum(fn(u.double(), v.double()) for u, v in terms)
            want = fn(a.double(), b.double())
            err = float((got - want).abs().max() / want.abs().max())
            assert err > 4 * CARD_TOL[name], (name, drop, err)

    def test_weight_gradient_repeats_bit_for_bit(self, cuda):
        x, w, gy = _card_case(cuda, 960, (64, 28, 64, 3, 1, 1), seed=5)
        first = _passes(lambda a, b: conv.conv2d(a, b, 1, 1), x, w, gy)
        second = _passes(lambda a, b: conv.conv2d(a, b, 1, 1), x, w, gy)
        for a, b in zip(first, second):
            assert torch.equal(a, b)

    def test_other_layout_is_made_channels_last(self, cuda):
        x, w, gy = _card_case(cuda, 4, (64, 9, 64, 3, 2, 1), seed=6)
        before = conv.relayouts.n
        got = _passes(lambda a, b: conv.conv2d(a, b, 2, 1), x.contiguous(), w, gy.contiguous())
        assert conv.relayouts.n == before + 2  # the input and the gradient, once each
        want = _passes(lambda a, b: conv.conv2d(a, b, 2, 1), x, w, gy)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_card_rejects_what_the_kernels_do_not_take(self, cuda):
        with pytest.raises(TypeError):
            conv.conv2d(torch.zeros(1, 32, 8, 8, device=cuda, dtype=torch.bfloat16),
                        torch.zeros(32, 32, 1, 3, 3, device=cuda, dtype=torch.bfloat16), 1, 1)
        with pytest.raises(ValueError):
            conv.conv2d(torch.zeros(1, 48, 8, 8, device=cuda),
                        torch.zeros(48, 48, 1, 3, 3, device=cuda), 1, 1)

    def test_train_step_matches_cudnn_within_the_benchmark_limits(self, cuda, monkeypatch):
        """One fp32 va train step at the benchmark's shapes (10 triplets of
        32 x 112x112 on the yuv420 wire), block convs on K3, against the same
        step from the same state with every conv through cuDNN fp32: the loss
        and the worst leaf's gradient (Adam's first moment, as the benchmark
        reads it) within the limits ``correct`` holds a run to
        (portbench/workloads/va-train.json: 6e-7, 0.02)."""
        import numpy as np

        from vqwild_tpu_torch.core.config import ModelConfig
        from vqwild_tpu_torch.models.arv import build_model
        from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
        from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, \
            make_train_step

        rng = np.random.default_rng(21)
        clips = rng.integers(0, 256, (30, 32, 112, 112, 3), dtype=np.uint8)
        labels = torch.from_numpy(rng.integers(0, 200, 30)).to(cuda)
        arrays = tuple(torch.from_numpy(a).to(cuda) for a in rgb_to_yuv420_host(clips))
        base = build_model(ModelConfig(method="va", nclass=200), device=cuda, seed=4)
        runs = {}
        for name in ("k3", "cudnn"):
            model = copy.deepcopy(base)
            if name == "cudnn":
                monkeypatch.setattr(conv, "conv2d", conv.conv2d_plain)
            tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100,
                                lr_decay_epoch=9)
            state = create_train_state(model, tx, seed=2)
            before = conv.launches["wgrad"].n
            state, losses = make_train_step(model, tx, wire="yuv420")(state, *arrays, labels)
            torch.cuda.synchronize()
            assert conv.launches["wgrad"].n - before == (19 if name == "k3" else 0)
            grads = {k: float((state.optimizer.state[p]["exp_avg"] / 0.1).double().norm())
                     for k, p in model.named_parameters() if p in state.optimizer.state}
            runs[name] = (float(losses["loss"]), grads)
        (loss, grads), (ref_loss, ref_grads) = runs["k3"], runs["cudnn"]
        assert abs(loss - ref_loss) / abs(ref_loss) < 6e-7
        med = statistics.median(ref_grads.values())
        moved = [k for k, v in ref_grads.items() if v >= 1e-3 * med]
        gap = max(abs(grads[k] - ref_grads[k]) / max(ref_grads[k], med) for k in moved)
        assert gap < 0.02
