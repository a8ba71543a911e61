"""The Video Swin trunk's window attention on the card
(vqwild_tpu_torch/models/swin3d.py): K6 (ops/window_attention.py) with the
relative-position bias and the shift's mask formed inside the kernel,
forward and backward, at Swin-B's stage-1 and stage-3 shapes, against
float64 (SDPA's path with the bias as its float ``attn_mask``), beside the
same products in TF32. Every test here needs a card;
the file imports nothing of the tests package (another ``tests`` package
may shadow it on the card's machine) and nothing of JAX.
"""

import copy

import pytest
import torch

from vqwild_tpu_torch.models import swin3d


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K6 runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the window attention against float64 on the card, as a share of the
# float64 result's largest entry: float32 through error-compensated TF32
# products and a softmax over 392 keys. Read on an H100: SDPA's
# memory-efficient kernel 5.6e-7 to 1.8e-6, K6 5.4e-7 to 1.5e-6 (o, dq, dk,
# dv, the bias table's gradient); the same products in TF32: 2.8e-4 to
# 1.1e-3
CARD_TOL = 1e-5
# (stage, clips, windows, heads) of Swin-B's window-attention calls at the
# cell's 9 clips: stage 1 (56x56 a frame, 128 windows of 8x7x7, 4 heads of
# 32) and stage 3 (14x14, 8 windows, 16 heads), each shifted (the -100 mask
# added to the bias) and not
CARD_CASES = [("s1", 9, 128, 4, (16, 56, 56)), ("s3", 9, 8, 16, (16, 14, 14))]


def _card_case(device, clips, windows, heads, grid, shifted, seed):
    """A stage's window attention on the card: its module (bias table normal
    at 0.1 so that the bias matters), q, k, v as the trunk lays them out,
    the output's gradient, and the shift's region ids where ``shifted``."""
    g = torch.Generator(device=device).manual_seed(seed)
    attn = swin3d.WindowAttention3D(32 * heads, swin3d.WINDOW, heads).to(device)
    with torch.no_grad():
        attn.relative_position_bias_table.copy_(
            0.1 * torch.randn(attn.relative_position_bias_table.shape, generator=g,
                              device=device))
    n = 392
    qkv = [torch.randn(clips, n, windows * heads, 32, generator=g, device=device)
           for _ in range(4)]
    regions = swin3d.compute_regions(grid, swin3d.WINDOW, (4, 3, 3), device) if shifted else None
    return attn, qkv, regions


def _attention_passes(attn, qkv, mask, dtype, fn=swin3d.attend):
    """(o, dq, dk, dv, d table) of the window attention in ``dtype``."""
    attn = copy.deepcopy(attn).to(dtype)
    table = attn.relative_position_bias_table
    q, k, v, do = (t.to(dtype).requires_grad_(i < 3) for i, t in enumerate(qkv))
    n, nw = q.shape[1], q.shape[2] // attn.heads
    o = fn(*(t.transpose(1, 2) for t in (q, k, v)), attn.bias(n, nw, mask, dtype), 32 ** -0.5)
    grads = torch.autograd.grad(o, (q, k, v, table), do.transpose(1, 2))
    return (o.transpose(1, 2),) + grads


def _k6_passes(attn, qkv, regions):
    """(o, dq, dk, dv, d table) of the window attention on the trunk's
    route for a CUDA float32 call: K6 on q, k, v [B, N, nW·C]."""
    from vqwild_tpu_torch.ops import window_attention as window_ops

    table = attn.relative_position_bias_table
    b, n, p, hd = qkv[0].shape
    q, k, v, do = (t.reshape(b, n, p * hd).clone().requires_grad_(i < 3)
                   for i, t in enumerate(qkv))
    assert swin3d.windowed(q, n, hd)
    o = window_ops.window_attention(q, k, v, table, attn.relative_position_index[:n, :n],
                                    regions, attn.heads, hd ** -0.5)
    grads = torch.autograd.grad(o, (q, k, v, table), do)
    return (o.view(b, n, p, hd),) + tuple(g.view(b, n, p, hd) for g in grads[:3]) + grads[3:]


def _explicit(q, k, v, bias, scale):
    return torch.softmax(q @ k.transpose(-2, -1) * scale + bias, -1) @ v


def _rel(a, b):
    return float((a.detach().double() - b.detach()).abs().max() / b.detach().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [True, False], ids=["shifted", "unshifted"])
@pytest.mark.parametrize("stage,clips,windows,heads,grid", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_the_window_attention_on_the_card(cuda, stage, clips, windows, heads, grid, shifted):
    """The trunk's window attention with its bias (and mask) on the card: K6
    runs it, forward and backward, one launch a pass, and neither SDPA's
    operators nor a softmax of the math path do; its output, the gradients
    of q, k and v, and the bias table's gradient lie within CARD_TOL of
    float64, and the same products in TF32 do not."""
    from vqwild_tpu_torch.ops import window_attention as window_ops

    attn, qkv, regions = _card_case(cuda, clips, windows, heads, grid, shifted, seed=windows)
    mask = None if regions is None else window_ops.region_mask(regions)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = {p: window_ops.launches[p].n for p in window_ops.PASSES}
    with torch.profiler.profile(activities=activities) as prof:
        got = _k6_passes(attn, qkv, regions)
        torch.cuda.synchronize()
    assert {p: window_ops.launches[p].n - before[p] for p in window_ops.PASSES} == {
        "fwd": 1, "bwd": 1}
    names = [e.key for e in prof.key_averages()]
    assert not any("scaled_dot_product" in n or "attention_math" in n or "oftmax" in n
                   for n in names), names
    kernels = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if kernels:  # the kernels the card ran, where the device trace caught them
        assert any("window_attention_fwd" in n for n in kernels), kernels
        assert any("window_attention_dq" in n for n in kernels), kernels
        assert not any("fmha" in n for n in kernels), kernels
    want = _attention_passes(attn, qkv, mask, torch.float64)
    errs = [_rel(a, b) for a, b in zip(got, want)]
    assert max(errs) < CARD_TOL, errs
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _attention_passes(attn, qkv, mask, torch.float32, fn=_explicit)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_errs = [_rel(a, b) for a, b in zip(tf32, want)]
    assert min(tf32_errs) > CARD_TOL, tf32_errs
    print(f"{stage} shifted={shifted}: K6 {errs}, tf32 {tf32_errs}")
