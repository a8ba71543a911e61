"""The trace's reduction: the window put on the host clock by the
sentinel, the union of device intervals, idle gaps named by host spans."""

import pytest

from portbench.harness import trace


class _Ev:
    def __init__(self, name, start_ns, dur_ns, kind="DeviceType.CUDA"):
        self._n, self._s, self._d, self._k = name, start_ns, dur_ns, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._k


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda s: events})()


def test_the_window_the_busy_union_and_the_named_gaps():
    ms = 1_000_000
    base = 5_000 * ms  # the device clock's origin is its own
    events = [
        _Ev("at::cuda::spin_kernel", base, 1000),  # host 10.000 s
        _Ev("before_window", base + 1 * ms, 5 * ms),  # clipped to the window's start
        _Ev("k1", base + 10 * ms, 20 * ms),
        _Ev("k2", base + 25 * ms, 10 * ms),  # overlaps k1: the union is 10-35 ms
        _Ev("k1", base + 60 * ms, 10 * ms),
        _Ev("cpu_op", base, 100 * ms, kind="DeviceType.CPU"),
        _Ev("portbench.mark", base, 100 * ms),  # a span's own device mark: not work
    ]
    spans = [(10.036, 10.059, "portbench.embed"), (10.030, 10.100, "portbench.outer")]
    s = trace.summarize(_Prof(events), h_mark=10.0, h0=10.004, h1=10.080, spans=spans)
    assert s.window_s == pytest.approx(0.076)
    assert s.busy_s == pytest.approx(0.002 + 0.025 + 0.010)  # [4,6] + [10,35] + [60,70] ms
    assert s.device_s("k1") == pytest.approx(0.030) and s.device_s("k2") == pytest.approx(0.010)
    assert "portbench.mark" not in s.device_s_by_name
    assert "at::cuda::spin_kernel" not in s.device_s_by_name
    gaps = dict((n.split(" @")[0], d) for n, d in s.idle_gaps)
    assert gaps["portbench.embed"] == pytest.approx(0.025)  # 35-60 ms: inside both spans
    assert s.idle_gaps[0][1] == pytest.approx(0.025)
    assert sum(d for _, d in s.idle_gaps) == pytest.approx(0.076 - s.busy_s)
    top = s.breakdown()["device_ops"]
    assert top[0][0] == "k1" and len(top) <= 10
