"""The eight va-train readers of the program's recorder
(harness/recorder.py) on a fake outcome and a recorder filled by hand, the
expected values worked out by hand; each reads nothing from an empty
recorder or from a program that has none."""

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.harness.common import Outcome, load_module
from portbench.harness.trace import TraceSummary
from vqwild_tpu_torch.core import profiling

WINDOW_S = 2.0

# three steps' markers (name, device time on the host clock), in the order
# the host recorded them, with a marker of no step before the first
MARKERS = [("other", 9.0),
           ("step.forward", 10.000), ("step.backward", 10.030),
           ("step.optimizer", 10.100), ("step.end", 10.110),
           ("step.forward", 10.112), ("step.backward", 10.140), ("other", 10.150),
           ("step.optimizer", 10.215), ("step.end", 10.226),
           ("step.forward", 10.230), ("step.backward", 10.262),
           ("step.optimizer", 10.330), ("step.end", 10.341)]
# (name, id, start, end) on the host clock
SPANS = [("train.data_wait", (1, 0), 1.000, 1.002),
         ("train.upload", (1, 0), 1.002, 1.012),
         ("train.data_wait", (1, 1), 1.012, 1.016),
         ("train.step", (1, 0), 1.016, 1.116),
         ("step.forward", (1, 0), 1.016, 1.050),
         ("train.upload", (1, 1), 1.116, 1.126),
         ("train.step", (1, 1), 1.126, 1.326),
         ("train.upload", (1, 2), 1.326, 1.336),
         ("train.step", (1, 2), 1.336, 1.636),
         ("loader.build", (1, 3), 1.0, 1.005),
         ("loader.build", (1, 4), 1.1, 1.107),
         ("loader.build", (1, 5), 1.2, 1.209)]

EXPECTED = {
    # forward: 30, 28, 32 ms; backward: 70, 75, 68 ms; optimizer: 10, 11, 11 ms
    "forward_ms.train": 30.0,
    "backward_ms.train": 70.0,
    "optimizer_ms.train": 11.0,
    # (10.112 - 10.110) + (10.230 - 10.226) = 6 ms over 2 s
    "step_gap_share.train": 0.3,
    # 0.1 + 0.2 + 0.3 s over 2 s
    "host_step_share.train": 30.0,
    # 3 x 10 ms over 2 s
    "upload_share.train": 1.5,
    # 2 + 4 ms over 2 s
    "data_wait_share.train": 0.3,
    # (5 + 7 + 9) / 3 ms
    "loader_build_ms.train": 7.0,
}


def outcome(window_s=WINDOW_S):
    return Outcome(setup_s=1.0, metrics={}, attempted=3, failed=0, checks=[],
                   memory_peak_bytes=0,
                   trace=TraceSummary(window_s=window_s, busy_s=0.9 * window_s))


@pytest.fixture()
def filled(monkeypatch):
    """A session of SPANS recorded through the recorder, and MARKERS as the
    card would resolve them (the CPU records none)."""
    with profile(activities=[ProfilerActivity.CPU]):
        for name, sid, t0, t1 in SPANS:
            profiling.add(name, t0, t1, sid)
    markers = [profiling.Marker(n, None, 100.0 + i, t) for i, (n, t) in enumerate(MARKERS)]
    monkeypatch.setattr(profiling, "markers", lambda: list(markers))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_on_a_recorder_filled_by_hand(filled, name):
    got = load_module("metrics", name).read(outcome(), None)
    assert got == pytest.approx(EXPECTED[name], rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_reads_nothing_from_an_empty_recorder(name):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("unrelated"):
            pass
    assert profiling.markers() == []
    assert load_module("metrics", name).read(outcome(), None) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_reads_nothing_from_a_program_without_a_recorder(monkeypatch, name):
    """The parent commit's program: core/profiling has no spans() there."""
    monkeypatch.delattr(profiling, "spans")
    assert load_module("metrics", name).read(outcome(), None) is None


def test_shares_need_a_traced_window(filled):
    for name in ("step_gap_share.train", "host_step_share.train", "upload_share.train",
                 "data_wait_share.train"):
        assert load_module("metrics", name).read(
            Outcome(setup_s=1.0, metrics={}, attempted=3, failed=0, checks=[],
                    memory_peak_bytes=0), None) is None
    assert load_module("metrics", "host_step_share.train").read(
        outcome(window_s=4.0), None) == pytest.approx(15.0)
