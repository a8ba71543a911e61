"""tsf_linear_roofline.train, the reader of K4's share of its bound in the
tsf-va-train cell: a recorder and a trace filled by hand, and nothing read
where the program has no K4 (no linear.flop counter), no trace or no
recorder."""

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.harness import common
from portbench.harness.common import Outcome, load_module
from portbench.harness.peaks import FP32_FLOPS
from portbench.harness.trace import TraceSummary
from vqwild_tpu_torch.core import profiling

NAME = "tsf_linear_roofline.train"
FLOP = 66_000_000_000_000  # the window's linear.flop
# K4's kernels in the fake trace, by the names the card gives them: the
# product, the weight gradient, its reduction, the weight's split (both)
K4_S = {"(anonymous namespace)::linear_gemm_kernel(CUtensorMap_st, CUtensorMap_st)": 0.500,
        "(anonymous namespace)::linear_wgrad_kernel(CUtensorMap_st, CUtensorMap_st)": 0.300,
        "(anonymous namespace)::linear_wgrad_reduce(float const*, float const*)": 0.004,
        "(anonymous namespace)::linear_prep_weight(float const*, float*)": 0.002,
        "(anonymous namespace)::linear_prep_weight_t(float const*, float*)": 0.003}
OTHERS_S = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80": 0.020,
            "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8": 0.001,
            "void at::native::vectorized_elementwise_kernel<4>": 0.100}


def ctx():
    return common.make_ctx("tsf-va-train", 1, 1.0, True, False, 0.0)


def outcome(trace=True):
    summary = TraceSummary(window_s=2.0, busy_s=1.9, device_s_by_name=dict(K4_S, **OTHERS_S))
    return Outcome(setup_s=1.0, metrics={}, attempted=2, failed=0, checks=[],
                   memory_peak_bytes=0, trace=summary if trace else None)


def record(counters):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("tsf.patch_embed"):
            for name, n in counters.items():
                profiling.count(name, n)


def test_the_window_s_flop_at_the_fp32_peak_over_k4_s_device_time():
    record({"linear.flop": FLOP, "linear.fwd": 109})
    got = load_module("metrics", NAME).read(outcome(), ctx())
    assert got == pytest.approx(100.0 * FLOP / FP32_FLOPS / sum(K4_S.values()), rel=1e-12)
    assert 0 < got < 100


def test_nothing_without_k4_s_counter():
    record({"tsf.relayout_bytes": 1_889_796_000})
    assert load_module("metrics", NAME).read(outcome(), ctx()) is None


def test_nothing_without_a_trace():
    record({"linear.flop": FLOP})
    assert load_module("metrics", NAME).read(outcome(trace=False), ctx()) is None


def test_nothing_from_a_program_without_a_recorder(monkeypatch):
    record({"linear.flop": FLOP})
    monkeypatch.delattr(profiling, "spans")
    assert load_module("metrics", NAME).read(outcome(), ctx()) is None
