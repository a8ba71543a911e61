"""Kernel K5 (vqwild_tpu_torch/ops/attention.py, csrc/short_attention.cu):
the plain version on the packed qkv against ``F.scaled_dot_product_attention``
in float64, the wrapper's dispatch and refusals, the TimeSformer trunk's
choice of K5 by shape, its counters, and the trunk on the CPU against the
plain reference through either attention path; on a GPU (marker ``cuda``)
the kernels against float64 beside PyTorch's memory-efficient kernel, the
launches of a train step and one step against the same step on SDPA.

No JAX here: the ``cuda`` tests run on a machine without it."""

import copy
import statistics
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from vqwild_tpu_torch.models import timesformer
from vqwild_tpu_torch.ops import attention as attention_ops

LENGTHS = [1, 2, 8, 16]
HEAD_DIMS = [16, 64]


def _case(n, length, heads, hd, seed=0, device="cpu", dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(n, length, 3 * heads * hd, generator=g, device=device)
    dout = torch.randn(n, length, heads * hd, generator=g, device=device)
    return qkv.to(dtype), dout.to(dtype)


def _sdpa(qkv, heads, scale, backend=None):
    """The trunk's SDPA path on a packed qkv: selects of a permuted view,
    the call, o's heads back into rows."""
    n, length, three_d = qkv.shape
    d = three_d // 3
    x = qkv.view(n, length, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    if backend is None:
        o = F.scaled_dot_product_attention(x[0], x[1], x[2], scale=scale)
    else:
        from torch.nn.attention import sdpa_kernel

        with sdpa_kernel([backend]):
            o = F.scaled_dot_product_attention(x[0], x[1], x[2], scale=scale)
    return o.transpose(1, 2).reshape(n, length, d)


def _passes(fn, qkv, dout):
    """(o, dqkv) of ``fn(qkv)`` with cotangent dout."""
    leaf = qkv.detach().requires_grad_()
    o = fn(leaf)
    return o.detach(), torch.autograd.grad(o, leaf, dout)[0]


def _rel_errs(got, want):
    return [float((a.double() - b.double()).abs().max() / b.double().abs().max())
            for a, b in zip(got, want)]


class TestPlain:
    @pytest.mark.parametrize("hd", HEAD_DIMS)
    @pytest.mark.parametrize("length", LENGTHS)
    def test_equals_sdpa_on_the_packed_qkv_in_float64(self, length, hd):
        """o and the packed dqkv, against SDPA's math path over the selects
        of the same qkv, to float64's rounding."""
        heads = 3
        qkv, dout = _case(5, length, heads, hd, seed=length * hd, dtype=torch.float64)
        got = _passes(lambda t: attention_ops.attention_plain(t, heads, hd ** -0.5), qkv, dout)
        want = _passes(lambda t: _sdpa(t, heads, hd ** -0.5), qkv, dout)
        assert [t.shape for t in got] == [(5, length, heads * hd), (5, length, 3 * heads * hd)]
        for err in _rel_errs(got, want):
            assert err < 1e-13

    def test_each_head_reads_its_own_features(self):
        """A head's q, k and v are its (3, heads, head_dim) slices of a row:
        moving one head's v changes only that head's columns of o."""
        heads, hd = 4, 8
        qkv, _ = _case(3, 5, heads, hd, seed=9, dtype=torch.float64)
        o = attention_ops.attention_plain(qkv, heads, 0.3)
        moved = qkv.clone()
        moved[..., 2 * heads * hd + 2 * hd:2 * heads * hd + 3 * hd] += 1.0  # head 2's v
        o2 = attention_ops.attention_plain(moved, heads, 0.3)
        changed = (o2 - o).abs().amax(dim=(0, 1)).view(heads, hd).amax(dim=1)
        assert changed[2] > 0.5 and changed[[0, 1, 3]].max() == 0


class TestDispatch:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_cpu_tensor_runs_the_plain_version_exactly(self, dtype):
        qkv, _ = _case(4, 8, 2, 16, dtype=dtype)
        torch.testing.assert_close(attention_ops.attention(qkv, 2, 0.25),
                                   attention_ops.attention_plain(qkv, 2, 0.25), rtol=0, atol=0)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_other_cpu_dtypes_raise(self, dtype):
        with pytest.raises(TypeError):
            attention_ops.attention(torch.zeros(2, 8, 96, dtype=dtype), 2, 0.25)

    def test_other_device_raises(self):
        with pytest.raises(ValueError):
            attention_ops.attention(torch.zeros(2, 8, 96, device="meta"), 2, 0.25)

    @pytest.mark.parametrize("length,hd,ok", [(8, 64, True), (2, 16, True), (1, 4, True),
                                              (16, 128, True), (197, 64, False),
                                              (17, 64, False), (8, 130, False),
                                              (8, 66, False), (8, 2, False), (0, 64, False)])
    def test_takes_short_sequences_and_head_dims_in_fours(self, length, hd, ok):
        assert attention_ops.takes(length, hd) is ok

    @pytest.mark.parametrize("shape,heads", [((4, 8, 96), 3), ((4, 17, 2304), 12),
                                             ((4, 8), 12), ((0, 8, 2304), 12),
                                             ((4, 8, 2300), 12), ((4, 8, 3 * 12 * 130), 12)])
    def test_geometry_refuses_what_the_kernels_do_not_take(self, shape, heads):
        with pytest.raises(ValueError):
            attention_ops.geometry(shape, heads)

    def test_geometry_of_the_trunk_s_temporal_call(self):
        assert attention_ops.geometry((5880, 8, 2304), 12) == (5880, 8, 64)

    def test_least_bytes_of_a_launch(self):
        """Forward: qkv in, o out; backward: qkv and dO in, dqkv out."""
        fwd, bwd = attention_ops.least_bytes(5880, 8, 768)
        rows = 5880 * 8 * 4
        assert (fwd, bwd) == (rows * 4 * 768, rows * 7 * 768) == (578_027_520, 1_011_548_160)

    def test_each_launch_counts_its_pass_and_its_bytes(self):
        """The recorder's ``attention.*`` counters (k5_roofline.train reads
        ``attention.bytes``), counted as the launchers count them; K4's
        calls give no bytes counter."""
        from torch.profiler import ProfilerActivity, profile

        from vqwild_tpu_torch.core import profiling
        from vqwild_tpu_torch.ops import linear as linear_ops

        fwd, bwd = attention_ops.least_bytes(5880, 8, 768)
        before = {p: attention_ops.launches[p].n for p in attention_ops.PASSES}
        with profile(activities=[ProfilerActivity.CPU]):
            attention_ops.launches.count("fwd", nbytes=fwd)
            attention_ops.launches.count("bwd", nbytes=bwd)
            linear_ops.launches.count("fwd", 2 * 8 * 32 * 32)
        counters = profiling.counters()
        assert {k: v for k, v in counters.items() if k.startswith("attention.")} == {
            "attention.fwd": 1, "attention.bwd": 1, "attention.bytes": fwd + bwd}
        assert "linear.bytes" not in counters and counters["linear.flop"] == 2 * 8 * 32 * 32
        assert {p: attention_ops.launches[p].n - before[p] for p in attention_ops.PASSES} == {
            "fwd": 1, "bwd": 1}


def _fake(device_type, dtype):
    return SimpleNamespace(is_cuda=device_type == "cuda", dtype=dtype)


class TestTrunkDispatch:
    """The trunk's attention: K5 for a CUDA float32 input of sequences and
    heads it takes, ``F.scaled_dot_product_attention`` for every other, with
    no setting."""

    @pytest.mark.parametrize("length,hd", [(8, 64), (2, 16)])
    def test_cuda_fp32_short_sequences_go_to_k5(self, length, hd):
        assert timesformer._short(_fake("cuda", torch.float32), length, hd)

    @pytest.mark.parametrize("x,length,hd", [
        (_fake("cuda", torch.float32), 197, 64),  # the spatial branch
        (_fake("cuda", torch.float32), 17, 16),  # the rehearsal's spatial branch
        (_fake("cpu", torch.float32), 8, 64),
        (_fake("cuda", torch.float64), 8, 64),
        (_fake("cuda", torch.bfloat16), 8, 64),
        (_fake("cuda", torch.float16), 8, 64)])
    def test_every_other_input_goes_to_sdpa(self, x, length, hd):
        assert not timesformer._short(x, length, hd)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_the_trunk_on_the_cpu_keeps_sdpa(self, dtype, monkeypatch):
        """Forward and backward of a small trunk on the CPU call neither K5
        nor its plain version, and launch nothing."""
        def refuse(*a, **k):
            raise AssertionError("K5's path taken off the card")

        monkeypatch.setattr(attention_ops, "attention", refuse)
        torch.manual_seed(3)
        trunk = timesformer.TimeSformer(64, depth=2, heads=4, mlp=128, patch=8, frames=2,
                                        crop=16).to(dtype)
        before = attention_ops.launches.n
        frames, clip = trunk.embed(torch.randn(3, 2, 16, 16, 3, dtype=dtype), train=True)
        (frames.sum() + clip.sum()).backward()
        assert attention_ops.launches.n == before


# the trunk on the CPU against the plain reference, as tests/test_torch_timesformer.py
# holds it (D 64, 4 heads, 2 blocks, MLP 256, 4 frames of 32² in patches of 8)
TRUNK = dict(depth=2, heads=4, mlp=256, patch=8, frames=4, crop=32, drop_path=0.3, ln_eps=1e-6)
TOL = {torch.float64: dict(fwd=1e-13, grad=1e-9), torch.float32: dict(fwd=2e-6, grad=5e-4)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("path", ["sdpa", "packed"])
def test_the_trunk_s_forward_and_backward_match_the_reference(path, dtype, monkeypatch):
    """The trunk's frame and clip embeddings and every parameter's gradient
    against the reference, with the temporal attention through SDPA (the CPU's
    path) and through the packed path that K5 takes on the card, run here by
    its plain version (the shape rule forced on for the temporal calls)."""
    from tests import timesformer_reference as ref  # here: another `tests` package may shadow it

    if path == "packed":
        calls = []

        def packed(x, length, hd):
            calls.append(length)
            return length == TRUNK["frames"]

        monkeypatch.setattr(timesformer, "_short", packed)
    torch.manual_seed(5)
    trunk = timesformer.TimeSformer(64, **TRUNK, dtype=dtype).to(dtype)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in trunk.parameters():  # every leaf non-zero, temporal_fc included
            p.copy_(0.02 * torch.randn(p.shape, generator=g, dtype=dtype) + 0.01)
    P = {k: v.detach().clone().requires_grad_() for k, v in trunk.state_dict().items()}
    x = torch.randn(3, 4, 32, 32, 3, generator=g, dtype=dtype)
    cfg = dict(TRUNK, dropout=0.0)
    masks = ref.draw_masks(torch.Generator().manual_seed(3), 3, 4, 16,
                           ref.drop_path_rates(0.3, 2))
    fe, ce = trunk.embed(x, train=True, generator=torch.Generator().manual_seed(3))
    rfe, rce = ref.trunk(P, x, cfg, masks)
    for got, want in ((fe, rfe), (ce, rce)):
        assert _rel_errs([got.detach()], [want.detach()])[0] < TOL[dtype]["fwd"]
    names = [n for n, _ in trunk.named_parameters()]
    got = torch.autograd.grad((fe.square().sum() + ce.sum()), list(trunk.parameters()))
    want = torch.autograd.grad((rfe.square().sum() + rce.sum()), [P[n] for n in names])
    scale = torch.stack([w.abs().max() for w in want]).median()
    for n, a, b in zip(names, got, want):
        assert float((a - b).abs().max() / torch.maximum(b.abs().max(), scale)) \
            < TOL[dtype]["grad"], n
    if path == "packed":  # each block's temporal call took it, no spatial call
        assert calls.count(TRUNK["frames"]) == 2 and len(calls) == 4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K5 runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K5 against float64 on the card, as a share of the reference's largest
# entry: exact fp32 products over at most 128 features and a softmax over
# at most 16 rows
CARD_TOL = 1e-5
# (name, n, L, heads, head_dim): the trunk's temporal call (30 clips of 196
# patch positions over 8 frames, 12 heads of 64), the CPU rehearsal's (2
# frames, 4 heads of 16), and every length up to 16
CARD_CASES = ([("temporal", 5880, 8, 12, 64), ("rehearsal", 96, 2, 4, 16)]
              + [(f"length{L}", 97, L, 12, 64) for L in range(1, 17)]
              + [("hd4", 33, 5, 3, 4), ("hd12", 33, 7, 5, 12), ("hd128", 33, 11, 2, 128)])


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("name,n,length,heads,hd", CARD_CASES,
                             ids=[c[0] for c in CARD_CASES])
    def test_forward_and_packed_gradient_match_float64(self, cuda, name, n, length, heads, hd):
        """o and dqkv within CARD_TOL of the plain version in float64, and no
        worse than the memory-efficient kernel's on the same inputs."""
        from torch.nn.attention import SDPBackend

        qkv, dout = _case(n, length, heads, hd, seed=n + length, device=cuda)
        scale = hd ** -0.5
        before = {p: attention_ops.launches[p].n for p in attention_ops.PASSES}
        got = _passes(lambda t: attention_ops.attention(t, heads, scale), qkv, dout)
        torch.cuda.synchronize()
        assert {p: attention_ops.launches[p].n - before[p] for p in attention_ops.PASSES} == {
            "fwd": 1, "bwd": 1}
        want = _passes(lambda t: attention_ops.attention_plain(t, heads, scale), qkv.double(),
                       dout.double())
        library = _passes(lambda t: _sdpa(t, heads, scale, SDPBackend.EFFICIENT_ATTENTION), qkv,
                          dout)
        for what, err, lib in zip(("o", "dqkv"), _rel_errs(got, want), _rel_errs(library, want)):
            assert err < CARD_TOL, (name, what, err)
            assert err <= lib, (name, what, err, lib)

    def test_repeats_bit_for_bit(self, cuda):
        qkv, dout = _case(5880, 8, 12, 64, seed=4, device=cuda)
        first = _passes(lambda t: attention_ops.attention(t, 12, 0.125), qkv, dout)
        second = _passes(lambda t: attention_ops.attention(t, 12, 0.125), qkv, dout)
        for a, b in zip(first, second):
            assert torch.equal(a, b)

    def test_card_refuses_what_the_kernels_do_not_take(self, cuda):
        before = attention_ops.launches.n
        for dtype in (torch.bfloat16, torch.float16, torch.float64):
            with pytest.raises(TypeError):
                attention_ops.attention(torch.zeros(2, 8, 96, device=cuda, dtype=dtype), 2, 0.25)
        for shape, heads in (((2, 17, 96), 2), ((2, 8, 3 * 2 * 130), 2), ((2, 8, 90), 3)):
            with pytest.raises(ValueError):
                attention_ops.attention(torch.zeros(shape, device=cuda), heads, 0.25)
        assert attention_ops.launches.n == before

    def test_a_train_step_runs_the_temporal_calls_on_k5_and_matches_sdpa(self, cuda,
                                                                          monkeypatch):
        """One fp32 va train step of the 12-block trunk (6 clips of 8 x 80²:
        25 patches, so the spatial calls run over 26 tokens) launches K5's
        forward and backward once a block, for the temporal calls alone, and
        lands within the limits ``correct`` holds the benchmark's runs to
        (portbench/workloads/tsf-va-train.json: loss 5e-7, worst leaf's
        gradient 2e-3) of the same step with every attention on SDPA."""
        import numpy as np

        from vqwild_tpu_torch.models.arv import ARVModel
        from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
        from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, \
            make_train_step

        rng = np.random.default_rng(24)
        clips = rng.integers(0, 256, (6, 8, 80, 80, 3), dtype=np.uint8)
        labels = torch.from_numpy(rng.integers(0, 200, 6)).to(cuda)
        arrays = tuple(torch.from_numpy(a).to(cuda) for a in rgb_to_yuv420_host(clips))
        torch.manual_seed(4)
        with cuda:
            base = ARVModel("va", nclass=200, feat_dim=768, trunk="timesformer_divst")
        g = torch.Generator(device=cuda).manual_seed(5)
        with torch.no_grad():  # temporal_fc starts at zero past block 0: give it a gradient path
            for blk in base.blocks:
                blk.temporal_fc.weight.normal_(0.0, 0.02, generator=g)
        lengths = []
        real = attention_ops.attention

        def seen(qkv, heads, scale):
            lengths.append(qkv.shape[1])
            return real(qkv, heads, scale)

        monkeypatch.setattr(attention_ops, "attention", seen)
        runs = {}
        for name in ("k5", "sdpa"):
            model = copy.deepcopy(base)
            if name == "sdpa":
                monkeypatch.setattr(timesformer, "_short", lambda x, length, hd: False)
            tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100,
                                lr_decay_epoch=9)
            state = create_train_state(model, tx, seed=2)
            before = {p: attention_ops.launches[p].n for p in attention_ops.PASSES}
            state, losses = make_train_step(model, tx, wire="yuv420")(state, *arrays, labels)
            torch.cuda.synchronize()
            launched = {p: attention_ops.launches[p].n - before[p] for p in attention_ops.PASSES}
            assert launched == ({"fwd": 12, "bwd": 12} if name == "k5" else {"fwd": 0, "bwd": 0})
            grads = {k: float((state.optimizer.state[p]["exp_avg"] / 0.1).double().norm())
                     for k, p in model.named_parameters() if p in state.optimizer.state}
            runs[name] = (float(losses["loss"]), grads)
            del model, state
            torch.cuda.empty_cache()
        assert lengths == [8] * 12
        (loss, grads), (ref_loss, ref_grads) = runs["k5"], runs["sdpa"]
        assert abs(loss - ref_loss) / abs(ref_loss) < 5e-7
        med = statistics.median(ref_grads.values())
        moved = [k for k, v in ref_grads.items() if v >= 1e-3 * med]
        gap = max(abs(grads[k] - ref_grads[k]) / max(ref_grads[k], med) for k in moved)
        assert gap < 2e-3
