"""Kernel K6 (vqwild_tpu_torch/ops/window_attention.py,
csrc/window_attention.cu): the plain version on the trunk's [B, N, nW·C]
layout against an explicit float64 softmax with ``WindowAttention3D.bias``
(o, dq, dk, dv and the table's gradient), the wrapper's shape rules and
counters, the Video Swin trunk's choice of K6 by shape and type, and the
trunk on the CPU through K6's path against the plain reference; on a GPU
(marker ``cuda``) the kernels against float64 at each Swin-B stage's shape,
bit-for-bit repeats, refusals, and one train step's launches against the
same step on SDPA.

No JAX here: the ``cuda`` tests run on a machine without it, where another
``tests`` package may shadow this one (the CPU tests import it inside)."""

import copy
import math
import statistics
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.models import swin3d
from vqwild_tpu_torch.ops import window_attention as window_ops

WINDOW = swin3d.WINDOW
SCALE = 32 ** -0.5
# (N, the window grid and shift whose regions a shifted case takes, or None
# for random region ids): a whole 8x7x7 window (two windows of an 8x7x14
# grid), the window shrunk to 2x7x7 (index[:98, :98], as a clip of 4 frames
# gives), and a length that is no window's (random regions)
LENGTHS = [(392, (8, 7, 14), (8, 7, 7), (4, 3, 3)), (98, (2, 14, 7), (2, 7, 7), (0, 3, 3)),
           (128, None, None, None)]


def _case(b, n, nw, heads, shifted, grid=None, window=None, shift=None, seed=0,
          device="cpu", dtype=torch.float64):
    g = torch.Generator(device=device).manual_seed(seed)
    f = nw * heads * 32
    q, k, v, do = (torch.randn(b, n, f, generator=g, device=device, dtype=dtype)
                   for _ in range(4))
    attn = swin3d.WindowAttention3D(32 * heads, WINDOW, heads).to(device=device, dtype=dtype)
    with torch.no_grad():
        attn.relative_position_bias_table.copy_(
            0.5 * torch.randn(attn.relative_position_bias_table.shape, generator=g,
                              device=device, dtype=dtype))
    regions = None
    if shifted:
        regions = (swin3d.compute_regions(grid, window, shift, device) if grid is not None else
                   torch.randint(0, 4, (nw, n), generator=g, device=device, dtype=torch.int32))
    return (q, k, v, do), attn, regions


def _passes(fn, qkvd, attn, regions):
    """(o, dq, dk, dv, d table) of ``fn`` on the [B, N, nW·C] layout."""
    q, k, v, do = (t.detach().requires_grad_(i < 3) for i, t in enumerate(qkvd))
    table = attn.relative_position_bias_table
    n = q.shape[1]
    o = fn(q, k, v, table, attn.relative_position_index[:n, :n], regions, attn.heads, SCALE)
    return (o.detach(),) + torch.autograd.grad(o, (q, k, v, table), do)


def _explicit(q, k, v, table, index, regions, heads, scale, attn=None):
    """softmax(q kᵀ · scale + ``WindowAttention3D.bias``) v, on [B, nW·heads,
    N, 32] views, in float64."""
    b, n, f = q.shape
    nw = f // (32 * heads)
    mask = None if regions is None else window_ops.region_mask(regions, q.dtype)
    bias = attn.bias(n, nw, mask, q.dtype)
    qh, kh, vh = (t.view(b, n, nw * heads, 32).transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-2, -1) * scale + bias, dim=-1)
    return (p @ vh).transpose(1, 2).reshape(b, n, f)


def _rel(a, b):
    return float((a.detach().double() - b.detach().double()).abs().max()
                 / b.detach().double().abs().max())


class TestPlain:
    @pytest.mark.parametrize("shifted", [True, False], ids=["shifted", "unshifted"])
    @pytest.mark.parametrize("n,grid,window,shift", LENGTHS, ids=[f"n{c[0]}" for c in LENGTHS])
    def test_matches_the_explicit_softmax_with_the_module_s_bias(self, n, grid, window, shift,
                                                                shifted):
        """o, dq, dk, dv and the table's gradient to float64's rounding."""
        nw = 2
        qkvd, attn, regions = _case(2, n, nw, 3, shifted, grid, window, shift, seed=n)
        got = _passes(window_ops.window_attention_plain, qkvd, attn, regions)
        want = _passes(lambda *a: _explicit(*a, attn=attn), qkvd, attn, regions)
        assert [tuple(t.shape) for t in got] == [(2, n, nw * 96)] * 4 + [(2535, 3)]
        for a, b in zip(got, want):
            assert _rel(a, b) < 1e-12
        assert got[4].abs().max() > 0

    def test_each_window_and_head_reads_its_own_slice(self):
        """Moving one (window, head)'s v changes only its 32 columns of o."""
        nw, heads = 3, 2
        (q, k, v, _), attn, regions = _case(2, 18, nw, heads, True, seed=4)
        idx = attn.relative_position_index[:18, :18]
        table = attn.relative_position_bias_table.detach()
        o = window_ops.window_attention_plain(q, k, v, table, idx, regions, heads, SCALE)
        v2 = v.clone()
        v2[..., 4 * 32:5 * 32] += 1.0  # window 2, head 0
        o2 = window_ops.window_attention_plain(q, k, v2, table, idx, regions, heads, SCALE)
        changed = (o2 - o).abs().amax(dim=(0, 1)) > 0
        assert changed[4 * 32:5 * 32].all() and changed.sum() == 32

    def test_the_mask_separates_the_regions(self):
        """A query's weights on keys of another region of its window are
        e^-100 of those within it: with all regions distinct but one pair,
        each other token attends to itself alone."""
        (q, k, v, _), attn, _ = _case(1, 6, 1, 1, False, seed=5)
        with torch.no_grad():
            attn.relative_position_bias_table.zero_()
        regions = torch.tensor([[0, 1, 2, 3, 4, 4]], dtype=torch.int32)
        o = window_ops.window_attention_plain(
            q, k, v, attn.relative_position_bias_table.detach(),
            attn.relative_position_index[:6, :6], regions, 1, SCALE)
        assert torch.allclose(o[0, :4], v[0, :4], atol=1e-30, rtol=1e-12)

    def test_a_cpu_tensor_runs_the_plain_version(self):
        qkvd, attn, regions = _case(2, 20, 2, 2, True, seed=6, dtype=torch.float32)
        before = window_ops.launches.n
        got = _passes(window_ops.window_attention, qkvd, attn, regions)
        want = _passes(window_ops.window_attention_plain, qkvd, attn, regions)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert window_ops.launches.n == before
        with pytest.raises(TypeError):
            window_ops.window_attention(*(t.to(torch.bfloat16) for t in qkvd[:3]),
                                        attn.relative_position_bias_table, None, None, 2, SCALE)


class TestShapes:
    @pytest.mark.parametrize("n", [1, 18, 98, 392])
    def test_takes_head_dim_32_up_to_a_whole_window(self, n):
        assert window_ops.takes(n, 32)

    @pytest.mark.parametrize("n,hd", [(0, 32), (393, 32), (392, 64), (98, 16), (18, 8)])
    def test_refuses_any_other(self, n, hd):
        assert not window_ops.takes(n, hd)

    def test_geometry_and_its_refusals(self):
        (q, k, v, _), attn, regions = _case(3, 392, 4, 2, True, seed=1, dtype=torch.float32)
        table, idx = attn.relative_position_bias_table, attn.relative_position_index
        assert window_ops.geometry(q, k, v, table, idx, regions, 2) == (3, 392, 8, 2535)
        assert window_ops.geometry(q, k, v, table, idx, None, 2) == (3, 392, 8, 2535)
        bad = [
            (q[:, :, :-32], k, v, table, idx, regions, 2),  # k and v differ from q
            (q[:, :, :100], k[:, :, :100], v[:, :, :100], table, idx, regions, 2),  # not 32s
            (torch.zeros(1, 393, 64), torch.zeros(1, 393, 64), torch.zeros(1, 393, 64),
             table, idx, None, 2),  # longer than a window
            (q, k, v, table[:, :1], idx, regions, 2),  # table of another head count
            (q, k, v, torch.zeros(2600, 2), idx, regions, 2),  # table past 2,560 rows
            (q, k, v, table, idx[:391, :391], regions, 2),  # index of another length
            (q, k, v, table, idx.to(torch.int32), regions, 2),  # index not int64
            (q, k, v, table, idx.t(), regions, 2),  # index with strided columns
            (q, k, v, table, idx, regions[:3], 2),  # regions of another window count
            (q, k, v, table, idx, regions.long(), 2),  # regions not int32
        ]
        for args in bad:
            with pytest.raises(ValueError):
                window_ops.geometry(*args)

    @pytest.mark.parametrize("window,n", [((8, 7, 7), 392), ((8, 7, 7), 98), ((2, 3, 3), 18),
                                          ((2, 3, 3), 5)])
    def test_the_trunk_s_index_is_row_plus_column_offsets(self, window, n):
        index = swin3d.relative_position_index(window)
        rows = math.prod(2 * w - 1 for w in window)
        window_ops.check_index(index[:n, :n], rows)

    @pytest.mark.parametrize("fault", ["not_separable", "shared_offset", "past_the_table",
                                       "negative", "not_square"])
    def test_check_index_refuses_an_index_the_kernels_misread(self, fault):
        index = swin3d.relative_position_index((2, 3, 3)).clone()
        rows = 3 * 5 * 5
        if fault == "not_separable":
            index[3, 5] += 1  # still in the table, no longer row + column
        elif fault == "shared_offset":
            index = index[:, :1].expand(-1, 18).clone()  # every column at offset 0
        elif fault == "past_the_table":
            rows = int(index.max())
        elif fault == "negative":
            index = index - index[0, 0]
        else:
            index = index[:, :9]
        with pytest.raises(ValueError):
            window_ops.check_index(index, rows)

    def test_the_module_refuses_to_load_an_index_the_kernels_misread(self):
        """A state_dict whose relative_position_index is not row plus
        column offsets is refused on load, before K6 could misread it."""
        attn = swin3d.WindowAttention3D(64, (2, 3, 3), 2)
        good = attn.state_dict()
        attn.load_state_dict(good)
        bad = dict(good, relative_position_index=good["relative_position_index"].clone())
        bad["relative_position_index"][3, 5] += 1
        with pytest.raises(ValueError):
            attn.load_state_dict(bad)
        trunk = swin3d.SwinTransformer3D(64, **TRUNK)
        state = trunk.state_dict()
        key = next(k for k in state if k.endswith("relative_position_index"))
        state[key] = state[key].clone()
        state[key][0, 1] = state[key][0, 0]  # two columns at one offset
        with pytest.raises(ValueError):
            trunk.load_state_dict(state)

    def test_work_counts_swin_work_s_products_and_the_bytes_once(self):
        """Two products forward and five backward at 2·N²·32 each a (clip,
        window, head): harness/swin_work's attention count; q, k, v, o
        forward and q, k, v, dO, dq, dk, dv backward, and the table."""
        b, n, p, rows, heads = 9, 392, 128 * 4, 2535, 4
        (ff, fb), (bf, bb) = window_ops.work(b, n, p, rows, heads)
        assert ff + bf == 7 * 2 * b * p * n * n * 32 and 5 * ff == 2 * bf
        slab = 4 * b * n * p * 32
        assert (fb, bb) == (4 * slab + 4 * rows * heads, 7 * slab + 4 * rows * heads)

    def test_a_launch_s_counters(self):
        """``launches.count`` bumps the always-on count and, under the
        recorder, window_attention.fwd/bwd, .flop and .bytes."""
        before = {p: window_ops.launches[p].n for p in window_ops.PASSES}
        (ff, fb), (bf, bb) = window_ops.work(2, 98, 16, 2535, 4)
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("swin.attn"):
                window_ops.launches.count("fwd", flop=ff, nbytes=fb)
                window_ops.launches.count("bwd", flop=bf, nbytes=bb)
            counters = profiling.counters()
        assert {k: v for k, v in counters.items() if k.startswith("window_attention.")} == {
            "window_attention.fwd": 1, "window_attention.bwd": 1,
            "window_attention.flop": ff + bf, "window_attention.bytes": fb + bb}
        assert {p: window_ops.launches[p].n - before[p] for p in window_ops.PASSES} == {
            "fwd": 1, "bwd": 1}


def _fake(device_type, dtype):
    return SimpleNamespace(is_cuda=device_type == "cuda", dtype=dtype)


class TestTrunkDispatch:
    """The Swin trunk's window attention: K6 for a CUDA float32 input of
    windows and heads it takes, SDPA for every other, with no setting."""

    @pytest.mark.parametrize("n", [392, 98, 1])
    def test_cuda_fp32_head_dim_32_goes_to_k6(self, n):
        assert swin3d.windowed(_fake("cuda", torch.float32), n, 32)

    @pytest.mark.parametrize("x,n,hd", [
        (_fake("cpu", torch.float32), 392, 32),
        (_fake("cpu", torch.float64), 392, 32),
        (_fake("cuda", torch.float64), 392, 32),
        (_fake("cuda", torch.bfloat16), 392, 32),
        (_fake("cuda", torch.float16), 392, 32),
        (_fake("cuda", torch.float32), 392, 64),  # a head_dim K6 does not take
        (_fake("cuda", torch.float32), 18, 8),  # the CPU tests' toy widths
        (_fake("cuda", torch.float32), 400, 32)])  # a window past 392 tokens
    def test_every_other_input_goes_to_sdpa(self, x, n, hd):
        assert not swin3d.windowed(x, n, hd)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_the_trunk_on_the_cpu_keeps_sdpa(self, dtype, monkeypatch):
        """Forward and backward of a small trunk at head_dim 32 on the CPU
        call neither K6 nor its plain version and launch nothing."""
        def refuse(*a, **k):
            raise AssertionError("K6's path taken off the card")

        monkeypatch.setattr(window_ops, "window_attention", refuse)
        torch.manual_seed(3)
        trunk = swin3d.SwinTransformer3D(64, **TRUNK, dtype=dtype).to(dtype)
        before = window_ops.launches.n
        frames, clip = trunk.embed(torch.randn(2, 6, 40, 36, 3, dtype=dtype), train=True,
                                   generator=torch.Generator().manual_seed(1))
        (frames.sum() + clip.sum()).backward()
        assert window_ops.launches.n == before


# a trunk at head_dim 32 on the CPU (widths 32 and 64 with 1 and 2 heads,
# window 2x3x3, clips of 6 frames of 40x36: both stages padded and shifted)
TRUNK = dict(embed_dim=32, depths=(2, 2), heads=(1, 2), window=(2, 3, 3), patch=(2, 4, 4),
             mlp_ratio=4, drop_path=0.3, ln_eps=1e-5)


def test_the_trunk_through_k6_s_path_matches_the_reference(monkeypatch):
    """The trunk's embeddings and every leaf's gradient in float64 against
    the plain reference, with each window attention on the path that K6
    takes on the card (the shape rule forced on for head_dim 32), run here
    by its plain version: the regions handed down, q, k, v and o in the
    [B, N, nW·C] layout, the table's gradient."""
    from tests import swin3d_reference as ref  # here: another `tests` package may shadow it

    calls = []
    real = window_ops.window_attention

    def seen(q, k, v, table, index, regions, heads, scale):
        calls.append((q.shape[1], regions is not None))
        return real(q, k, v, table, index, regions, heads, scale)

    monkeypatch.setattr(window_ops, "window_attention", seen)
    monkeypatch.setattr(swin3d, "windowed", lambda x, n, hd: hd == 32)
    dtype = torch.float64
    torch.manual_seed(5)
    trunk = swin3d.SwinTransformer3D(64, **TRUNK, dtype=dtype).to(dtype)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():  # every leaf non-zero, the bias tables too
        for name, p in trunk.named_parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g, dtype=dtype)
                    + (1.0 if "norm" in name and name.endswith("weight") else 0.0))
    P = {k: v.detach().clone().requires_grad_(v.is_floating_point())
         for k, v in trunk.state_dict().items()}
    x = torch.randn(2, 6, 40, 36, 3, generator=g, dtype=dtype)
    cfg = dict(TRUNK, dropout=0.0)
    masks = ref.draw_masks(torch.Generator().manual_seed(3), 2,
                           ref.drop_path_rates(0.3, TRUNK["depths"]))
    fe, ce = trunk.embed(x, train=True, generator=torch.Generator().manual_seed(3))
    rfe, rce = ref.trunk(P, x, cfg, masks)
    assert _rel(fe, rfe) < 1e-13 and _rel(ce, rce) < 1e-13
    assert calls == [(18, False), (18, True)] * 2
    names = [n for n, _ in trunk.named_parameters()]
    got = torch.autograd.grad(fe.square().sum() + ce.sum(), list(trunk.parameters()))
    want = torch.autograd.grad(rfe.square().sum() + rce.sum(), [P[n] for n in names])
    scale = torch.stack([w.abs().max() for w in want]).median()
    for n, a, b in zip(names, got, want):
        assert float((a - b).abs().max() / torch.maximum(b.abs().max(), scale)) < 1e-9, n
    assert any(n.endswith("relative_position_bias_table") for n in names)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K6 runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K6 against float64 on the card, as a share of the float64 result's
# largest entry: 3xTF32 products and a softmax over 392 keys
CARD_TOL = 1e-5
# (stage, clips, windows, heads, grid, shift) of Swin-B's calls at 32 x 224²
# (each stage's windows and heads; 3 clips, and 10 at stage 4 so that the
# backward's clip groups of 9 split)
CARD_CASES = [("s1", 3, 128, 4, (16, 56, 56), (4, 3, 3)),
              ("s2", 3, 32, 8, (16, 28, 28), (4, 3, 3)),
              ("s3", 3, 8, 16, (16, 14, 14), (4, 3, 3)),
              ("s4", 10, 2, 32, (16, 7, 7), (4, 0, 0))]


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("shifted", [True, False], ids=["shifted", "unshifted"])
    @pytest.mark.parametrize("stage,clips,nw,heads,grid,shift", CARD_CASES,
                             ids=[c[0] for c in CARD_CASES])
    def test_matches_float64(self, cuda, stage, clips, nw, heads, grid, shift, shifted):
        """o, dq, dk, dv and the table's gradient within CARD_TOL of the
        plain version in float64, one launch a pass."""
        qkvd, attn, regions = _case(clips, 392, nw, heads, shifted, grid, WINDOW, shift,
                                    seed=nw, device=cuda, dtype=torch.float32)
        before = {p: window_ops.launches[p].n for p in window_ops.PASSES}
        got = _passes(window_ops.window_attention, qkvd, attn, regions)
        torch.cuda.synchronize()
        assert {p: window_ops.launches[p].n - before[p] for p in window_ops.PASSES} == {
            "fwd": 1, "bwd": 1}
        want = _passes(window_ops.window_attention_plain, tuple(t.double() for t in qkvd),
                       copy.deepcopy(attn).double(), regions)
        errs = [_rel(a, b) for a, b in zip(got, want)]
        assert max(errs) < CARD_TOL, (stage, errs)

    @pytest.mark.parametrize("n", [1, 57, 98, 200])
    def test_other_lengths_match_float64(self, cuda, n):
        """Against float64 as above; at one token o is v and the float64
        gradients of q, k and the table are 0, so those three are held to
        CARD_TOL of dv's largest entry."""
        qkvd, attn, regions = _case(3, n, 2, 2, True, seed=n, device=cuda, dtype=torch.float32)
        got = _passes(window_ops.window_attention, qkvd, attn, regions)
        want = _passes(window_ops.window_attention_plain, tuple(t.double() for t in qkvd),
                       copy.deepcopy(attn).double(), regions)
        errs = [_rel(a, b) for a, b in zip(got, want)]
        if n == 1:
            scale = float(want[3].abs().max())
            errs = [errs[0], errs[3]] + [float(got[i].abs().max()) / scale for i in (1, 2, 4)]
        assert max(errs) < CARD_TOL, (n, errs)

    def test_repeats_bit_for_bit(self, cuda):
        qkvd, attn, regions = _case(9, 392, 8, 16, True, (16, 14, 14), WINDOW, (4, 3, 3),
                                    seed=2, device=cuda, dtype=torch.float32)
        first = _passes(window_ops.window_attention, qkvd, attn, regions)
        second = _passes(window_ops.window_attention, qkvd, attn, regions)
        for a, b in zip(first, second):
            assert torch.equal(a, b)

    def test_card_refuses_what_the_kernels_do_not_take(self, cuda):
        (q, k, v, _), attn, regions = _case(2, 98, 2, 2, True, seed=3, device=cuda,
                                            dtype=torch.float32)
        table, idx = attn.relative_position_bias_table, attn.relative_position_index[:98, :98]
        before = window_ops.launches.n
        for dtype in (torch.bfloat16, torch.float16, torch.float64):
            with pytest.raises(TypeError):
                window_ops.window_attention(q.to(dtype), k.to(dtype), v.to(dtype), table, idx,
                                            regions, 2, SCALE)
        with pytest.raises(ValueError):  # features no whole number of 32-wide heads
            window_ops.window_attention(q[..., :96], k[..., :96], v[..., :96], table, idx,
                                        regions, 2, SCALE)
        long = torch.zeros(1, 393, 64, device=cuda)
        with pytest.raises(ValueError):  # longer than a window
            window_ops.window_attention(long, long, long, table, idx, None, 2, SCALE)
        assert window_ops.launches.n == before

    def test_a_train_step_launches_k6_once_a_block_and_matches_sdpa(self, cuda, monkeypatch):
        """One fp32 va train step of Swin-B (3 clips of 16 x 112²) launches
        K6's forward and backward once in each of the 24 blocks (counted
        always and by the recorder) and lands within the limits ``correct``
        holds the benchmark's runs to (portbench/workloads/vswin-va-train
        .json: loss 1e-6, worst leaf's gradient 2e-3) of the same step with
        every window attention on SDPA."""
        import numpy as np

        from vqwild_tpu_torch.models.arv import ARVModel
        from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
        from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, \
            make_train_step

        rng = np.random.default_rng(26)
        clips = rng.integers(0, 256, (3, 16, 112, 112, 3), dtype=np.uint8)
        labels = torch.from_numpy(rng.integers(0, 200, 3)).to(cuda)
        arrays = tuple(torch.from_numpy(a).to(cuda) for a in rgb_to_yuv420_host(clips))
        torch.manual_seed(4)
        with cuda:
            base = ARVModel("va", nclass=200, feat_dim=1024, trunk="swin3d_b")
        runs = {}
        for name in ("k6", "sdpa"):
            model = copy.deepcopy(base)
            if name == "sdpa":
                monkeypatch.setattr(swin3d, "windowed", lambda x, n, hd: False)
            tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100,
                                lr_decay_epoch=9)
            state = create_train_state(model, tx, seed=2)
            before = {p: window_ops.launches[p].n for p in window_ops.PASSES}
            with profile(activities=[ProfilerActivity.CPU]):
                with profiling.span("swin.attn"):
                    state, losses = make_train_step(model, tx, wire="yuv420")(state, *arrays,
                                                                              labels)
                    torch.cuda.synchronize()
                counters = profiling.counters()
            launched = {p: window_ops.launches[p].n - before[p] for p in window_ops.PASSES}
            want = 24 if name == "k6" else 0
            assert launched == {"fwd": want, "bwd": want}
            assert counters.get("window_attention.fwd", 0) == want
            assert counters.get("window_attention.bwd", 0) == want
            grads = {k: float((state.optimizer.state[p]["exp_avg"] / 0.1).double().norm())
                     for k, p in model.named_parameters() if p in state.optimizer.state}
            runs[name] = (float(losses["loss"]), grads)
            del model, state
            torch.cuda.empty_cache()
        (loss, grads), (ref_loss, ref_grads) = runs["k6"], runs["sdpa"]
        assert abs(loss - ref_loss) / abs(ref_loss) < 1e-6
        med = statistics.median(ref_grads.values())
        moved = [k for k, v in ref_grads.items() if v >= 1e-3 * med]
        gap = max(abs(grads[k] - ref_grads[k]) / max(ref_grads[k], med) for k in moved)
        assert gap < 2e-3
