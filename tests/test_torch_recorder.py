"""The port's recorder (vqwild_tpu_torch/core/profiling.py) on the CPU.

Off, it records nothing and allocates nothing; under a CPU torch.profiler
session it records spans with their parent, id and thread from 8 threads,
counters that lose no update, drops the last session's records when a new
session starts, and keeps at most MAX_RECORDS. ``phase`` fills its dict and
records. The training loop over the real step and the real loader records
its spans once a step with the step's id, the step's phases inside, and one
``loader.build`` a batch; ``trace`` writes the spans as a process of their
own. No ``record_function`` or NVTX range is left in the port.

The ``cuda`` tests (the port alone: ``pytest --noconftest -m cuda``) read a
``torch.cuda._sleep`` between two markers on the host clock, and check that
markers and their resolution add no synchronising call to a train step.
"""

import json
import pathlib
import sys
import threading
import time
import tracemalloc
import warnings
from contextlib import nullcontext

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.data.frames import SyntheticFrameStore
from vqwild_tpu_torch.data.labels import SplitSpec
from vqwild_tpu_torch.data.schema import load_trimmed_db
from vqwild_tpu_torch.data.triplets import PrefetchLoader, TripletDataset
from vqwild_tpu_torch.models.arv import ARVModel, init_model
from vqwild_tpu_torch.train.loop import TrainLoop
from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

PORT = pathlib.Path(__file__).resolve().parent.parent / "vqwild_tpu_torch"
FRAMES, CROP, H, W = 2, 32, 40, 48  # tests/test_torch_loop.py's sizes


def small_state(nclass, device="cpu"):
    """A seeded full-width ARVModel with dropout, and Adam."""
    model = init_model(ARVModel("va", nclass=nclass, dropout=0.5, nl_dropout=0.2),
                       seed=0).to(device)
    tx = make_optimizer(init_lr=1e-3, weight_decay=1e-5, steps_per_epoch=3, lr_decay_epoch=1)
    return create_train_state(model, tx, seed=1)


def write_db(root, nclass=4, per_class=3):
    """A trimmed DB of ``nclass`` training classes and its SplitSpec."""
    labels = [f"class_{i}" for i in range(nclass)]
    training = {label: [{"video_id": f"v{i}_{j}", "label": label, "segment": [1.0, 11.0],
                         "border": [1.0, 11.0], "activitynet_subset": "training",
                         "activitynet_duration": 64 / 3, "is_query": 0,
                         "retrieval_type": "base"} for j in range(per_class)]
                for i, label in enumerate(labels)}
    path = root / "arv_db_recorder.json"
    path.write_text(json.dumps({"training": training, "validation": {}, "testing": {}}))
    spec = SplitSpec("recorder", tuple(labels), (), (), str(path), "")
    return load_trimmed_db(str(path)), spec


def session():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_allocates_nothing(monkeypatch):
    with session():
        with profiling.span("before"):
            pass
    before = profiling.spans()
    assert [s.name for s in before] == ["before"]
    sid = (0, 1)
    # one shared context, and no clock read
    assert all(profiling.span("off", i) is profiling.span("x") for i in range(100))
    monkeypatch.setattr(profiling.time, "perf_counter", None)
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        for _ in range(2000):
            with profiling.span("off"):
                pass
            with profiling.span("off", sid):
                pass
            profiling.count("off")
            profiling.mark("off")
            profiling.add("off", 0.0, 1.0)
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
        monkeypatch.undo()
    mine = [tracemalloc.Filter(True, profiling.__file__),
            tracemalloc.Filter(True, profiling.contextlib.__file__)]
    grown = sum(d.size_diff for d in snap1.filter_traces(mine).compare_to(
        snap0.filter_traces(mine), "filename"))
    assert grown <= 0
    assert profiling.spans() == before
    assert profiling.counters() == {} and profiling.markers() == []


def test_spans_carry_parent_id_and_thread():
    with session():
        with profiling.span("outer", 7):
            with profiling.span("inner"):
                with profiling.span("leaf", "own"):
                    pass
        with profiling.span("alone"):
            pass
    by = {s.name: s for s in profiling.spans()}
    assert [s.name for s in profiling.spans()] == ["leaf", "inner", "outer", "alone"]
    assert by["outer"].parent is None and by["outer"].id == 7
    assert by["inner"].parent == "outer" and by["inner"].id == 7
    assert by["leaf"].parent == "inner" and by["leaf"].id == "own"
    assert by["alone"].parent is None and by["alone"].id is None
    assert by["outer"].start <= by["inner"].start <= by["leaf"].start
    assert by["leaf"].end <= by["inner"].end <= by["outer"].end
    assert {s.thread for s in by.values()} == {threading.get_ident()}


def test_eight_threads_record_every_span_and_count():
    n_threads, n = 8, 300
    idents = {}

    def work(t):
        idents[t] = threading.get_ident()
        for i in range(n):
            with profiling.span("outer", (t, i)):
                with profiling.span("inner"):
                    profiling.count("hits")
            profiling.count("pairs", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with session():
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
                assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    spans = profiling.spans()
    assert len(spans) == 2 * n_threads * n
    for t in range(n_threads):
        outer = [s for s in spans if s.name == "outer" and s.id[0] == t]
        inner = [s for s in spans if s.name == "inner" and s.id[0] == t]
        assert sorted(s.id[1] for s in outer) == list(range(n))
        assert sorted(s.id[1] for s in inner) == list(range(n))
        assert {s.thread for s in outer + inner} == {idents[t]}
        assert all(s.parent == "outer" for s in inner)
        assert all(s.parent is None for s in outer)
    assert profiling.counters() == {"hits": n_threads * n, "pairs": 2 * n_threads * n}


def test_a_new_session_drops_the_last_one():
    with session():
        with profiling.span("first"):
            profiling.count("a", 3)
    assert [s.name for s in profiling.spans()] == ["first"]
    assert profiling.counters() == {"a": 3}
    with session():
        profiling.add("second", 1.0, 2.5, id=4)
        profiling.count("b")
    assert profiling.spans() == [profiling.Span("second", 4, 1.0, 2.5, None,
                                                threading.get_ident())]
    assert profiling.counters() == {"b": 1}


def test_a_session_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 10)
    with session():
        for i in range(25):
            with profiling.span("s", i):
                pass
    assert [s.id for s in profiling.spans()] == list(range(15, 25))


def test_phase_fills_its_dict_and_records():
    timings = {}
    with profiling.phase(timings, "off"):
        pass
    with session():
        for _ in range(2):
            with profiling.phase(timings, "score"):
                with profiling.span("inside"):
                    pass
    assert set(timings) == {"off", "score"} and timings["score"] > 0
    spans = profiling.spans()
    assert [s.name for s in spans] == ["inside", "score"] * 2
    assert all(s.parent == "score" for s in spans if s.name == "inside")
    recorded = sum(s.end - s.start for s in spans if s.name == "score")
    assert 0 < recorded <= timings["score"]


def loop_parts(tmp_path, steps=3, batch=2, workers=2):
    db, spec = write_db(tmp_path)
    ds = TripletDataset(db, spec, SyntheticFrameStore(h=H, w=W), train_frames=FRAMES,
                        crop_size=CROP, nclass=4)
    loader = PrefetchLoader(ds, batch_size=batch, steps_per_epoch=steps, workers=workers,
                            seed=3)
    state = small_state(4)
    return loader, state, make_train_step(state.model, state.tx)


@pytest.mark.parametrize("epochs", [1, 2])
def test_the_training_loop_records_each_step(tmp_path, epochs):
    steps, batch = 4, 2
    loader, state, step = loop_parts(tmp_path, steps, batch)
    with session():
        TrainLoop(step, loader, epochs=epochs, print_freq=2).run(state)
    spans = profiling.spans()
    ids = [(e, i) for e in range(epochs) for i in range(steps)]
    names = ("train.upload", "train.step", "step.forward", "step.backward",
             "step.optimizer", "heads.memory_update", "loader.build")
    for name in names:
        got = sorted(s.id for s in spans if s.name == name)
        assert got == ids, name
    # the batch after each epoch's last one is the epoch's end: one wait more
    waits = sorted(s.id for s in spans if s.name == "train.data_wait")
    assert waits == sorted(ids + [(e, steps) for e in range(epochs)])
    parents = {s.name: s.parent for s in spans}
    assert parents["train.step"] is None and parents["train.upload"] is None
    assert parents["step.forward"] == parents["step.backward"] == "train.step"
    assert parents["step.optimizer"] == "train.step"
    assert parents["heads.memory_update"] == "step.forward"
    loop_thread = {s.thread for s in spans if s.name.startswith(("train.", "step."))}
    builders = {s.thread for s in spans if s.name == "loader.build"}
    assert len(loop_thread) == 1 and not builders & loop_thread
    for sid in ids:  # a step's phases lie inside its step call, in order
        step_span, fwd, bwd, opt = (next(s for s in spans if s.name == n and s.id == sid)
                                    for n in ("train.step", "step.forward", "step.backward",
                                              "step.optimizer"))
        assert step_span.start <= fwd.start <= fwd.end <= bwd.start <= bwd.end
        assert bwd.end <= opt.start <= opt.end <= step_span.end
    # drains: at the print after the third step and at each epoch's end
    assert sorted(s.id for s in spans if s.name == "train.drain") == sorted(
        [(e, 3) for e in range(epochs)] + [(e, steps) for e in range(epochs)])
    one = next(iter(loader.epoch(0)))
    batch_bytes = sum(a.nbytes for a in one.arrays + (one.labels,))
    assert one.labels.shape == (batch * 3,)
    assert profiling.counters() == {
        "train.steps": epochs * steps, "train.clips": epochs * steps * batch * 3,
        "train.upload_bytes": epochs * steps * batch_bytes,
        "train.host_syncs": 2 * epochs, "loader.batches": epochs * steps}
    assert profiling.markers() == []  # no device markers on the CPU


def test_the_scan_path_records_a_group_as_one_step(tmp_path):
    from vqwild_tpu_torch.train.step import make_scanned_train_step

    loader, state, step = loop_parts(tmp_path, steps=5, batch=2, workers=1)
    scan = make_scanned_train_step(state.model, state.tx)
    with session():
        TrainLoop(step, loader, epochs=1, print_freq=10, scan_fn=scan, scan_steps=2).run(state)
    spans = profiling.spans()
    assert sorted(s.id for s in spans if s.name == "train.step") == [(0, 0), (0, 2), (0, 4)]
    assert sorted(s.id for s in spans if s.name == "train.data_wait") == [
        (0, 0), (0, 2), (0, 4), (0, 5)]
    assert sorted(s.id for s in spans if s.name == "step.forward") == [
        (0, 0), (0, 0), (0, 2), (0, 2), (0, 4)]
    assert profiling.counters()["train.steps"] == 5


def test_the_loader_records_one_build_a_batch(tmp_path):
    loader, _, _ = loop_parts(tmp_path, steps=5, batch=2, workers=2)
    with session():
        batches = list(loader.epoch(4))
    spans = profiling.spans()
    assert len(batches) == 5
    assert sorted(s.id for s in spans if s.name == "loader.build") == [(4, k) for k in range(5)]
    assert len({s.thread for s in spans}) == 2
    assert profiling.counters() == {"loader.batches": 5}


def test_trace_writes_the_spans_as_their_own_process(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", 3):
            torch.ones(4).sum()
            with profiling.span("inner"):
                torch.zeros(8).add_(1)
            profiling.count("adds", 2)
    doc = json.loads((tmp_path / "profile" / "trace.json").read_text())
    events = doc["traceEvents"]
    mine = {e["name"]: e for e in events
            if e.get("pid") == profiling.TRACK_PID and e.get("ph") == "X"}
    assert set(mine) == {"outer", "inner"}
    assert mine["inner"]["args"] == {"id": "3", "parent": "outer"}
    assert [(e["name"], e["args"]) for e in events if e.get("pid") == profiling.TRACK_PID
            and e.get("ph") == "C"] == [("adds", {"value": 2})]
    names = [e for e in events if e.get("ph") == "M" and e.get("pid") == profiling.TRACK_PID]
    assert {e["args"]["name"] for e in names} == {"vqwild_tpu_torch spans", "device markers"}
    # on the profiler's clock: the profiled ops lie inside the spans around them
    op = next(e for e in events if e.get("name") == "aten::add_" and e.get("ph") == "X")
    inner = mine["inner"]
    slack = 1e3  # us: two clocks read one after the other
    assert inner["ts"] - slack <= op["ts"] <= inner["ts"] + inner["dur"] + slack
    assert mine["outer"]["ts"] <= inner["ts"] and (
        inner["ts"] + inner["dur"] <= mine["outer"]["ts"] + mine["outer"]["dur"])


def test_no_record_function_or_nvtx_in_the_port():
    hits = [f"{p.relative_to(PORT)}" for p in sorted(PORT.rglob("*.py"))
            if "record_function" in p.read_text() or "nvtx" in p.read_text()]
    assert hits == []


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnTheCard:
    def test_a_sleep_between_two_markers_reads_its_duration(self, cuda):
        with profile(activities=[ProfilerActivity.CUDA]):
            profiling.begin(cuda)
            torch.cuda._sleep(1000)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            profiling.mark("a", 1)
            e0.record()
            torch.cuda._sleep(50_000_000)
            e1.record()
            profiling.mark("b")
            host = time.perf_counter()
            torch.cuda.synchronize()
            done = time.perf_counter()
        a, b = profiling.markers()
        assert (a.name, a.id, b.name) == ("a", 1, "b")
        want = e0.elapsed_time(e1) / 1e3
        assert want > 5e-3
        assert b.device - a.device == pytest.approx(want, rel=0.02, abs=2e-4)
        # the host recorded b long before the device reached it, and saw it done
        assert a.host <= b.host <= host < b.device <= done + 1e-3

    def test_markers_add_no_synchronising_call_to_a_step(self, cuda):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        state = small_state(4, device=cuda)
        g = torch.Generator().manual_seed(0)
        y = torch.randint(0, 255, (6, FRAMES, CROP, CROP), generator=g, dtype=torch.uint8)
        uv = torch.randint(0, 255, (6, FRAMES, CROP // 2, CROP // 2, 2), generator=g,
                           dtype=torch.uint8)
        labels = torch.tensor([0, 0, 1, 2, 2, 3])
        arrays = [t.to(cuda) for t in (y, uv, labels)]
        step = make_train_step(state.model, state.tx, wire="yuv420")
        step(state, *arrays)  # warm: cuDNN's plans, Adam's state
        torch.cuda.synchronize()

        def syncs(recording):
            """The synchronising calls a step and the markers' resolution make."""
            with profile(activities=[ProfilerActivity.CUDA]) if recording else nullcontext():
                profiling.begin(cuda)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        step(state, *arrays)
                        profiling.settle()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
            return [str(w.message) for w in caught
                    if "called a synchronizing" in str(w.message)]

        with warnings.catch_warnings(record=True) as caught:  # the detector sees a readback
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.ones(1, device=cuda).item()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert any("called a synchronizing" in str(w.message) for w in caught)
        assert syncs(True) == syncs(False)
        names = [m.name for m in profiling.markers()]
        assert names == ["step.forward", "step.backward", "step.optimizer", "step.end"]
        t = [m.device for m in profiling.markers()]
        assert t == sorted(t)
