"""k6_roofline.train, the reader of K6's share of its bound in the
vswin-va-train cell: a recorder and a trace filled by hand, the larger of
the operations' and the bytes' least time, and nothing read where the
program has no K6 (no window_attention counters), no trace or no
recorder."""

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.harness import common
from portbench.harness.common import Outcome, load_module
from portbench.harness.peaks import FP32_FLOPS, HBM_BYTES_PER_S
from portbench.harness.trace import TraceSummary
from vqwild_tpu_torch.core import profiling

NAME = "k6_roofline.train"
# 23 steps of the cell's calls: 2.46 TFLOP and ~12 GB of operands a step
FLOP = 23 * 2_460_000_000_000
NBYTES = 23 * 12_000_000_000
K6_S = {"(anonymous namespace)::window_attention_fwd((anonymous namespace)::Args)": 0.45,
        "(anonymous namespace)::window_attention_dq((anonymous namespace)::Args)": 0.50,
        "(anonymous namespace)::window_attention_dkv((anonymous namespace)::Args)": 0.55,
        "(anonymous namespace)::window_attention_bias_sum((anonymous namespace)::Args, int)": 0.02,
        "(anonymous namespace)::window_attention_bias_table((anonymous namespace)::Args)": 0.01}
OTHERS_S = {"(anonymous namespace)::linear_gemm_kernel(CUtensorMap_st, CUtensorMap_st)": 3.1,
            "void at::native::elementwise_kernel<128, 2>": 0.9}


def ctx():
    return common.make_ctx("vswin-va-train", 1, 1.0, True, False, 0.0)


def outcome(trace=True, kernels=True):
    names = dict(K6_S, **OTHERS_S) if kernels else dict(OTHERS_S)
    summary = TraceSummary(window_s=10.0, busy_s=9.9, device_s_by_name=names)
    return Outcome(setup_s=1.0, metrics={}, attempted=2, failed=0, checks=[],
                   memory_peak_bytes=0, trace=summary if trace else None)


def record(counters):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("swin.patch_embed"):
            for name, n in counters.items():
                profiling.count(name, n)


def test_the_window_s_operations_at_the_fp32_peak_over_k6_s_device_time():
    record({"window_attention.flop": FLOP, "window_attention.bytes": NBYTES,
            "window_attention.fwd": 23 * 24, "window_attention.bwd": 23 * 24})
    got = load_module("metrics", NAME).read(outcome(), ctx())
    assert got == pytest.approx(100.0 * FLOP / FP32_FLOPS / sum(K6_S.values()), rel=1e-12)
    assert FLOP / FP32_FLOPS > NBYTES / HBM_BYTES_PER_S and 0 < got < 100


def test_the_bytes_where_they_take_longer():
    record({"window_attention.flop": 1_000_000, "window_attention.bytes": NBYTES})
    got = load_module("metrics", NAME).read(outcome(), ctx())
    assert got == pytest.approx(100.0 * NBYTES / HBM_BYTES_PER_S / sum(K6_S.values()),
                                rel=1e-12)


def test_nothing_without_k6_s_counters():
    record({"linear.flop": 66_000_000_000_000})
    assert load_module("metrics", NAME).read(outcome(), ctx()) is None


def test_nothing_without_a_trace_or_k6_s_kernels():
    record({"window_attention.flop": FLOP, "window_attention.bytes": NBYTES})
    assert load_module("metrics", NAME).read(outcome(trace=False), ctx()) is None
    assert load_module("metrics", NAME).read(outcome(kernels=False), ctx()) is None


def test_nothing_from_a_program_without_a_recorder(monkeypatch):
    record({"window_attention.flop": FLOP, "window_attention.bytes": NBYTES})
    monkeypatch.delattr(profiling, "spans")
    assert load_module("metrics", NAME).read(outcome(), ctx()) is None
