"""The vswin-va-train cell: Video Swin's work counted against hand-worked
values, its readers on a recorder and a trace filled by hand, its
reference's layout against the program's model, and the cell rehearsed on
the CPU (sound, the control in TF32, and half of each checked batch left
out)."""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import common, swin_work, tsf_work
from portbench.harness.common import Outcome, load_module
from portbench.harness.peaks import FP32_FLOPS, HBM_BYTES_PER_S
from portbench.harness.trace import TraceSummary
from vqwild_tpu_torch.core import profiling

CELL = "vswin-va-train"
SEED = 2**31 + 17
READERS = ["swin_attention_ms.train", "swin_mlp_ms.train", "swin_relayout_mb.train",
           "swin_attention_roofline.train", "swin_linear_roofline.train"]


def _block(tokens, c, windows, heads, n=392, hd=32):
    """A block's multiply-adds, by hand: qkv, proj, the attention's two
    products over every window and head, fc1 and fc2."""
    return (tokens * c * 3 * c + tokens * c * c + windows * heads * 2 * n * n * hd
            + 2 * tokens * c * 4 * c)


def test_forward_macs_of_swin_b_at_32x224():
    s1 = _block(50176, 128, 128, 4)
    assert s1 == 2_466_250_752 + 822_083_584 + 5_035_261_952 + 6_576_668_672
    s2, s3, s4 = _block(12544, 256, 32, 8), _block(3136, 512, 8, 16), _block(784, 1024, 2, 32)
    merges = 12544 * 512 * 256 + 3136 * 1024 * 512 + 784 * 2048 * 1024
    patch = 50176 * 96 * 128
    assert swin_work.patch_macs(32, 224, (2, 4, 4), 128) == patch == 616_562_688
    total = patch + 2 * s1 + 2 * s2 + 18 * s3 + 2 * s4 + merges
    assert swin_work.forward_macs() == total == 281_332_416_512
    # the attention products' share: 39.0 GMAC
    attention = 2 * 5_035_261_952 + 2 * 32 * 8 * 2 * 392 * 392 * 32 + 18 * 8 * 16 * 2 * 392 \
        * 392 * 32 + 2 * 2 * 32 * 2 * 392 * 392 * 32
    assert attention == pytest.approx(39.0e9, rel=2e-3)


def test_train_flops_leave_out_the_patch_embedding_s_input_gradient():
    per_clip = swin_work.train_flops_per_clip()
    assert per_clip == 2 * (3 * 281_332_416_512 - 616_562_688) == 1_686_761_373_696


def test_windows_shrink_pad_and_merge_odd():
    """A 3x9x9 grid under 2x3x3 windows: padded to 4x9x9, merged to 3x5x5
    (H and W padded to even), then 3x3x3, where H and W fit one window."""
    st = list(swin_work.stages(6, 36, (2, 4, 4), 16, (2, 2, 2), (2, 3, 3)))
    assert [(s["tokens"], s["padded"], s["windows"], s["n"]) for s in st] == [
        (243, 324, 2 * 3 * 3, 18), (75, 144, 2 * 2 * 2, 18), (27, 36, 2, 18)]
    # one tubelet: D shrinks to 1, the window to 1x3x3
    assert next(swin_work.stages(2, 36, (2, 4, 4), 16, (2,), (2, 3, 3)))["n"] == 9


def test_attention_work_and_its_least_time():
    calls = swin_work.attention_calls(9, 32, 224, (2, 4, 4), 128, (2, 2, 18, 2), (4, 8, 16, 32),
                                      (8, 7, 7))
    assert calls == {"s1": (1152, 4, 392, 32), "s2": (288, 8, 392, 32),
                     "s3": (72, 16, 392, 32), "s4": (18, 32, 392, 32)}
    flops, nbytes = swin_work.attention_call_work(1152, 4, 392, 32, 128)
    tflops, tbytes = tsf_work.attention_work(1152, 4, 392, 32)
    assert flops == tflops == 14 * 1152 * 4 * 392 * 392 * 32
    assert nbytes == tbytes + 4 * 128 * 4 * 392 * 392
    # every stage is bound by operations: 392 x 32 at 4 bytes is 98 FLOP a byte
    least = swin_work.attention_least_seconds({"s1": 2, "s2": 2, "s3": 18, "s4": 2}, 9,
                                              32, 224, (2, 4, 4), 128, (2, 2, 18, 2),
                                              (4, 8, 16, 32), (8, 7, 7))
    want = sum(n * tsf_work.attention_work(*calls[s])[0] for s, n in
               {"s1": 2, "s2": 2, "s3": 18, "s4": 2}.items()) / FP32_FLOPS
    assert least == pytest.approx(want, rel=1e-12)
    assert nbytes / HBM_BYTES_PER_S < flops / FP32_FLOPS


def test_the_reference_layout_is_the_program_s_state():
    from portbench.reference import swin3d as ref_swin
    from vqwild_tpu_torch.models.arv import ARVModel

    layout = ref_swin.va_layout(200, 1024, 128, (2, 2, 18, 2), (4, 8, 16, 32), (8, 7, 7),
                                (2, 4, 4), 4)
    with torch.device("meta"):
        model = ARVModel("va", nclass=200, feat_dim=1024, trunk="swin3d_b")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, s, _ in layout}
    small = ref_swin.va_layout(10, 64, 16, (2, 2, 2), (2, 2, 4), (2, 3, 3), (2, 4, 4), 4)
    sd = ref_swin.make_state(small, 5, (2, 3, 3), torch.device("cpu"))
    assert all(v.abs().sum() > 0 for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))
    model = ARVModel("va", nclass=10, feat_dim=64, trunk="swin3d_b",
                     trunk_args=dict(embed_dim=16, depths=(2, 2, 2), heads=(2, 2, 4),
                                     window=(2, 3, 3)))
    index = model.layers[0].blocks[0].attn.relative_position_index.clone()
    model.load_state_dict(sd, strict=True)
    assert torch.equal(model.layers[2].blocks[1].attn.relative_position_index, index)


# (name, device time on the host clock): two forwards of two blocks and a
# merge, a forward cut off by the window (no swin.end), markers of no forward
MARKERS = [("swin.mlp", 0.5),
           ("step.forward", 1.000), ("swin.attn", 1.001), ("swin.mlp", 1.004),
           ("swin.merge", 1.009), ("swin.attn", 1.010), ("swin.mlp", 1.013),
           ("swin.end", 1.020), ("step.backward", 1.022),
           ("step.forward", 2.000), ("swin.attn", 2.001), ("swin.mlp", 2.005),
           ("swin.merge", 2.011), ("swin.attn", 2.012), ("swin.mlp", 2.016),
           ("swin.end", 2.027), ("step.backward", 2.030),
           ("step.forward", 3.000), ("swin.attn", 3.001), ("swin.mlp", 3.9)]
SPANS = [("swin.patch_embed", 1.0, 1.001), ("swin.patch_embed", 2.0, 2.001)]
COUNTERS = {"swin.relayout_bytes": 2 * 5_135_000_000, "swin.attn.s1": 4, "swin.attn.s2": 4,
            "swin.attn.s3": 36, "swin.attn.s4": 4, "linear.flop": 400_000_000_000_000}
ATTENTION_S = 0.400  # the attention kernels' device seconds in the fake trace
K4_S = 3.0  # K4's


def ctx():
    return common.make_ctx(CELL, 1, 1.0, True, False, 0.0)


def outcome():
    trace = TraceSummary(window_s=10.0, busy_s=9.9, device_s_by_name={
        "fmha_cutlassF_f32_aligned_64x64_rf_sm80": 0.150,
        "fmha_cutlassB_f32_aligned_64x64_k32_sm80": 0.250,
        "(anonymous namespace)::linear_gemm_kernel(CUtensorMap_st, CUtensorMap_st)": 2.0,
        "(anonymous namespace)::linear_wgrad_kernel(CUtensorMap_st, CUtensorMap_st)": 1.0,
        "void at::native::vectorized_elementwise_kernel<4>": 1.0})
    return Outcome(setup_s=1.0, metrics={}, attempted=2, failed=0, checks=[],
                   memory_peak_bytes=0, trace=trace)


def expected():
    p = ctx().params
    least = swin_work.attention_least_seconds(
        {"s1": 4, "s2": 4, "s3": 36, "s4": 4}, 9, p["frames"], p["crop"], p["patch"],
        p["embed_dim"], p["depths"], p["heads"], p["window"])
    return {
        # attention (3 + 3) ms and (4 + 4) ms; mlp (5 + 7), (6 + 11)
        "swin_attention_ms.train": 7.0, "swin_mlp_ms.train": 14.5,
        "swin_relayout_mb.train": 5135.0,
        "swin_attention_roofline.train": 100.0 * least / ATTENTION_S,
        "swin_linear_roofline.train": 100.0 * 400e12 / FP32_FLOPS / K4_S}


@pytest.fixture()
def filled(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        for name, t0, t1 in SPANS:
            profiling.add(name, t0, t1)
        for name, n in COUNTERS.items():
            profiling.count(name, n)
    markers = [profiling.Marker(n, None, 100.0 + i, t) for i, (n, t) in enumerate(MARKERS)]
    monkeypatch.setattr(profiling, "markers", lambda: list(markers))


@pytest.mark.parametrize("name", READERS)
def test_each_reader_on_a_recorder_filled_by_hand(filled, name):
    got = load_module("metrics", name).read(outcome(), ctx())
    assert got == pytest.approx(expected()[name], rel=1e-9)
    if name.endswith("roofline.train"):
        assert 0 < got < 100


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_without_the_trunk_s_records(name):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("unrelated"):
            pass
    assert load_module("metrics", name).read(outcome(), ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_from_a_program_without_a_recorder(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    assert load_module("metrics", name).read(outcome(), ctx()) is None


def test_the_last_line_of_a_rehearsal():
    p = subprocess.run([sys.executable, os.path.join(common.BENCH_DIR, "run.py"), "--workload",
                        CELL, "--seed", str(SEED), "--seconds", "1", "--trace", "0",
                        "--rehearse"], cwd=common.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_clips_per_s", "setup_s"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap", "state_gap",
                                   "loader_mismatch"}


@pytest.mark.parametrize("mode", ["control", "fault:half_batch"])
def test_the_control_and_the_fault_are_not_correct(rehearse, mode):
    _, out = rehearse(CELL, SEED, 0.5, mode=mode)
    assert not all(c.ok for c in out.checks), [(c.name, c.value, c.limit) for c in out.checks]
