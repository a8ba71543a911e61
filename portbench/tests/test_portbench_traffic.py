"""The open-loop schedule and the load generator's timing from due time."""

import json
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from portbench.harness import common, traffic


def test_every_seed_gets_the_same_gaps_in_another_order():
    a = traffic.schedule(40.0, 30.0, 3_000_000_001)
    b = traffic.schedule(40.0, 30.0, 2**31 + 12345)
    assert len(a) == len(b) == 1200
    assert a[0] == b[0] == 0.0 and np.all(np.diff(a) > 0)
    assert a[-1] == pytest.approx(30.0) and b[-1] == pytest.approx(30.0)
    assert np.allclose(np.sort(np.diff(a)), np.sort(np.diff(b)))
    assert not np.allclose(np.diff(a), np.diff(b))
    assert np.array_equal(a, traffic.schedule(40.0, 30.0, 3_000_000_001))


def test_the_gaps_are_exponential_at_the_rate():
    gaps = np.diff(traffic.schedule(25.0, 100.0, 9))
    assert gaps.mean() == pytest.approx(1 / 25.0, rel=1e-3)
    assert abs(np.median(gaps) - np.log(2) / 25.0) < 2e-3


def test_picks_and_clips_come_from_the_seed():
    p = traffic.picks(500, 256, 11)
    assert p.min() >= 0 and p.max() < 256 and np.array_equal(p, traffic.picks(500, 256, 11))
    y, uv = traffic.smooth_clip(11, 3, 4, 112)
    y2, uv2 = traffic.smooth_clip(11, 3, 4, 112)
    assert y.shape == (4, 112, 112) and uv.shape == (4, 56, 56, 2)
    assert np.array_equal(y, y2) and np.array_equal(uv, uv2)
    assert not np.array_equal(y, traffic.smooth_clip(11, 4, 4, 112)[0])


def test_moment_windows_and_their_rows_invert():
    d = traffic.video_durations(12)
    vid, first, count, start, end, n_clips = traffic.moment_windows(d, 5, 26)
    rows = traffic.window_row(vid, start, end, d, 5, 26)
    assert np.array_equal(rows, np.arange(vid.size))
    assert np.all(end - start == 5 * count) and np.all(first + count <= n_clips[vid])
    assert traffic.window_row(np.array([0]), np.array([2.5]), np.array([7.5]), d, 5, 26)[0] == -1


class _Slow(BaseHTTPRequestHandler):
    """One request at a time, 0.1 s each: a queue forms at 20 requests/s."""

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.1)
        body = json.dumps({"results": []}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_latency_is_timed_from_the_due_time_whatever_the_server_does():
    server = HTTPServer(("127.0.0.1", 0), _Slow)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    spec = {"endpoint": "moments", "pool": 4, "k": 10, "nms": 0.5, "feat_dim": 8, "seed": 5,
            "rate": 20.0, "seconds": 1.0, "timeout_s": 30, "grace_s": 30}
    loadgen = f"{common.BENCH_DIR}/harness/loadgen.py"
    try:
        p = subprocess.Popen([sys.executable, loadgen, json.dumps(spec)], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True)
        assert json.loads(p.stdout.readline())["ready"] is True
        p.stdin.write(json.dumps({"port": server.server_address[1]}) + "\n")
        p.stdin.flush()
        assert json.loads(p.stdout.readline())["warmed"] is True
        p.stdin.write(json.dumps({"go": True}) + "\n")
        p.stdin.flush()
        out = json.loads(p.stdout.readline())
        assert p.wait(timeout=60) == 0
    finally:
        server.shutdown()
        server.server_close()
    lat = np.array(out["latency"])
    assert out["n"] == 20 and all(s == 200 for s in out["status"])
    # open loop: every request left near its due time, however long the queue
    assert max(out["late"]) < 0.05
    # 2.0 s of service for arrivals over 1.0 s: the queue's tail waits for it
    assert lat.min() >= 0.1 and lat.max() > 0.8
