"""k5_roofline.train, the reader of K5's share of its bound in the
tsf-va-train cell: a recorder and a trace filled by hand, and nothing read
where the program has no K5 (no attention.bytes counter), no trace or no
recorder."""

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.harness import common
from portbench.harness.common import Outcome, load_module
from portbench.harness.peaks import HBM_BYTES_PER_S
from portbench.harness.trace import TraceSummary
from vqwild_tpu_torch.core import profiling

NAME = "k5_roofline.train"
NBYTES = 18 * 12 * (578_027_520 + 1_011_548_160)  # 18 steps of 12 calls, forward and backward
# K5's kernels in the fake trace, by the names the card gives them
K5_S = {"void (anonymous namespace)::short_attention_fwd<8>(float const*, float*, "
        "(anonymous namespace)::Shape, float)": 0.045,
        "void (anonymous namespace)::short_attention_bwd<8>(float const*, float const*, "
        "float*, (anonymous namespace)::Shape, float, float)": 0.082}
OTHERS_S = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80": 0.330,
            "fmha_cutlassB_f32_aligned_64x64_k64_sm80": 0.740,
            "(anonymous namespace)::linear_gemm_kernel(CUtensorMap_st, CUtensorMap_st)": 3.4}


def ctx():
    return common.make_ctx("tsf-va-train", 1, 1.0, True, False, 0.0)


def outcome(trace=True):
    summary = TraceSummary(window_s=10.0, busy_s=9.9, device_s_by_name=dict(K5_S, **OTHERS_S))
    return Outcome(setup_s=1.0, metrics={}, attempted=2, failed=0, checks=[],
                   memory_peak_bytes=0, trace=summary if trace else None)


def record(counters):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("tsf.patch_embed"):
            for name, n in counters.items():
                profiling.count(name, n)


def test_the_window_s_bytes_at_the_memory_rate_over_k5_s_device_time():
    record({"attention.bytes": NBYTES, "attention.fwd": 216, "attention.bwd": 216})
    got = load_module("metrics", NAME).read(outcome(), ctx())
    assert got == pytest.approx(100.0 * NBYTES / HBM_BYTES_PER_S / sum(K5_S.values()), rel=1e-12)
    assert 0 < got < 100


def test_nothing_without_k5_s_counter():
    record({"linear.flop": 66_000_000_000_000})
    assert load_module("metrics", NAME).read(outcome(), ctx()) is None


def test_nothing_without_a_trace():
    record({"attention.bytes": NBYTES})
    assert load_module("metrics", NAME).read(outcome(trace=False), ctx()) is None


def test_nothing_without_k5_s_kernels_in_the_trace():
    record({"attention.bytes": NBYTES})
    summary = TraceSummary(window_s=10.0, busy_s=9.9, device_s_by_name=dict(OTHERS_S))
    out = Outcome(setup_s=1.0, metrics={}, attempted=2, failed=0, checks=[],
                  memory_peak_bytes=0, trace=summary)
    assert load_module("metrics", NAME).read(out, ctx()) is None


def test_nothing_from_a_program_without_a_recorder(monkeypatch):
    record({"attention.bytes": NBYTES})
    monkeypatch.delattr(profiling, "spans")
    assert load_module("metrics", NAME).read(outcome(), ctx()) is None
