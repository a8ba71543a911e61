"""The tsf-va-train cell: TimeSformer's work counted against hand-worked
values, its readers on a recorder filled by hand, its reference's layout
against the program's model, and the cell rehearsed on the CPU (sound, the
control in TF32, and half of each checked batch left out)."""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import common, tsf_work
from portbench.harness.common import Outcome, load_module
from portbench.harness.peaks import FP32_FLOPS, HBM_BYTES_PER_S
from portbench.harness.trace import TraceSummary
from vqwild_tpu_torch.core import profiling

CELL = "tsf-va-train"
SEED = 2**31 + 11
READERS = ["tsf_temporal_ms.train", "tsf_spatial_ms.train", "tsf_mlp_ms.train",
           "tsf_relayout_mb.train", "tsf_attention_roofline.train"]


def test_forward_macs_at_8x224():
    # a block, by hand: temporal qkv 1568x768x2304 + attention 196x12x2x8x8x64
    # + proj and temporal_fc 2x1568x768x768; spatial qkv 1576x768x2304
    # + attention 8x12x2x197x197x64 + proj 1576x768x768; MLP 1569x2x768x3072
    block = (2_774_532_096 + 19_267_584 + 1_849_688_064 + 2_788_687_872 + 476_884_992
             + 929_562_624 + 7_403_470_848)
    assert block == 16_242_094_080
    assert tsf_work.patch_macs(8, 224, 16, 768) == 924_844_032
    assert tsf_work.forward_macs() == 924_844_032 + 12 * block == 195_829_972_992


def test_train_flops_leave_out_the_patch_embedding_s_input_gradient():
    per_clip = tsf_work.train_flops_per_clip()
    assert per_clip == 2 * (3 * 195_829_972_992 - 924_844_032) == 1_173_130_149_888
    assert 30 * per_clip == pytest.approx(35.19e12, rel=1e-3)


def test_attention_work_and_its_least_time():
    # temporal: 30 clips x 196 positions, 12 heads, 8 frames of 64
    flops, nbytes = tsf_work.attention_work(5880, 12, 8, 64)
    assert flops == 14 * 5880 * 12 * 64 * 64 == 4_046_192_640
    assert nbytes == 8 * 4 * 5880 * 12 * 8 * 64 == 1_156_055_040
    # spatial: 240 frames, 12 heads, 197 tokens of 64
    sflops, sbytes = tsf_work.attention_work(240, 12, 197, 64)
    assert sflops == 14 * 240 * 12 * 197 * 197 * 64 == 100_145_848_320
    assert sbytes == 8 * 4 * 240 * 12 * 197 * 64 == 1_161_953_280
    calls = tsf_work.attention_calls(30, 8, 224, 16, 768, 12)
    assert calls == {"temporal": (5880, 12, 8, 64), "spatial": (240, 12, 197, 64)}
    # the temporal call is bound by bytes, the spatial one by operations
    least = tsf_work.attention_least_seconds({"temporal": 24, "spatial": 12}, 30, 8, 224, 16,
                                             768, 12)
    assert least == pytest.approx(24 * nbytes / HBM_BYTES_PER_S + 12 * sflops / FP32_FLOPS)


def test_the_reference_layout_is_the_program_s_state():
    from portbench.harness.weights import make_state
    from portbench.reference import timesformer as ref_tsf
    from vqwild_tpu_torch.models.arv import ARVModel

    layout = ref_tsf.va_layout(200, 768, 12, 3072, 16, 8, 224)
    with torch.device("meta"):
        model = ARVModel("va", nclass=200, feat_dim=768, trunk="timesformer_divst")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, s, _ in layout}
    small = ref_tsf.va_layout(10, 64, 2, 256, 8, 2, 32)
    sd = make_state(small, 5, torch.device("cpu"))
    assert all(v.abs().sum() > 0 for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))
    model = ARVModel("va", nclass=10, feat_dim=64, trunk="timesformer_divst",
                     trunk_args=dict(depth=2, heads=4, mlp=256, patch=8, frames=2, crop=32))
    model.load_state_dict(sd, strict=True)


# (name, device time on the host clock): two forwards of two blocks, a
# forward cut off by the window (no tsf.end), markers of no forward
MARKERS = [("tsf.mlp", 0.5),
           ("step.forward", 1.000), ("tsf.temporal", 1.001), ("tsf.spatial", 1.004),
           ("tsf.mlp", 1.009), ("tsf.temporal", 1.011), ("tsf.spatial", 1.014),
           ("tsf.mlp", 1.019), ("tsf.end", 1.021), ("step.backward", 1.022),
           ("step.forward", 2.000), ("tsf.temporal", 2.001), ("tsf.spatial", 2.005),
           ("tsf.mlp", 2.011), ("tsf.temporal", 2.014), ("tsf.spatial", 2.018),
           ("tsf.mlp", 2.024), ("tsf.end", 2.027), ("step.backward", 2.030),
           ("step.forward", 3.000), ("tsf.temporal", 3.001), ("tsf.spatial", 3.9)]
SPANS = [("tsf.patch_embed", 1.0, 1.001), ("tsf.patch_embed", 2.0, 2.001)]
COUNTERS = {"tsf.relayout_bytes": 2 * 1_886_000_000, "tsf.attn.temporal": 24,
            "tsf.attn.spatial": 24}
# the attention kernels' device seconds in the fake trace
ATTENTION_S = 0.050


def ctx():
    return common.make_ctx(CELL, 1, 1.0, True, False, 0.0)


def outcome():
    trace = TraceSummary(window_s=2.0, busy_s=1.9, device_s_by_name={
        "fmha_cutlassF_f32_aligned_64x64_rf_sm80": 0.020,
        "fmha_cutlassB_f32_aligned_64x64_k64_sm80": 0.030, "gemm": 1.0})
    return Outcome(setup_s=1.0, metrics={}, attempted=2, failed=0, checks=[],
                   memory_peak_bytes=0, trace=trace)


def expected():
    c = ctx()
    p = c.params
    least = tsf_work.attention_least_seconds({"temporal": 24, "spatial": 24}, 30, p["frames"],
                                             p["crop"], p["patch"], p["feat_dim"], p["heads"])
    return {
        # temporal: (3 + 3) ms and (4 + 4) ms; spatial (5 + 5), (6 + 6); mlp (2 + 2), (3 + 3)
        "tsf_temporal_ms.train": 7.0, "tsf_spatial_ms.train": 11.0, "tsf_mlp_ms.train": 5.0,
        "tsf_relayout_mb.train": 1886.0,
        "tsf_attention_roofline.train": 100.0 * least / ATTENTION_S}


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
