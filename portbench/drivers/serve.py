"""Entry kind ``serve``: the port's HTTP front-end, micro-batching service
and index, open loop.

The server is built in the run as ``python -m vqwild_tpu_torch.serve``
builds it: ``QueryService`` over a ``GalleryIndex`` with the folded fp32
trunk of ``make_feat_fn(wire="yuv420")`` (``endpoint: clip``), or over a
``MomentIndex`` (``endpoint: moments``), behind ``serve/http.make_server``
on a free localhost port. The benchmark makes the weights, the gallery,
the clips and the queries from the seed and hands the service wrapped
callables, which count and time each call. A load generator in its own
process sends the cell's schedule (harness/loadgen.py); each request is
timed from its due time to the last byte of its reply.

``correct`` judges a sample of the answered requests, drawn from the seed,
against the plain reference (reference/arv.py, reference/retrieval.py)
once the server is down and its memory freed.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import urllib.request
from typing import Dict, List

import numpy as np

from portbench.harness import traffic
from portbench.harness.common import Check, Ctx, Outcome, log, now
from portbench.harness.trace import Tracer
from portbench.harness.weights import make_state
from portbench.reference import arv as ref_arv
from portbench.reference import retrieval as judge

LOADGEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "harness",
                       "loadgen.py")


class Calls:
    """Host time and size of each call through a wrapped callable, and a
    ``portbench.<name>`` host span in a traced run."""

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.span = tracer, f"portbench.{name}"
        self.seconds: List[float] = []
        self.sizes: List[tuple] = []

    def wrap(self, fn, size=lambda *a, **k: ()):
        def wrapped(*args, **kwargs):
            t0 = now()
            out = fn(*args, **kwargs)
            t1 = now()
            self.seconds.append(t1 - t0)
            self.sizes.append(size(*args, **kwargs))
            self.tracer.add(self.span, t0, t1)
            return out
        return wrapped

    def reset(self):
        self.seconds.clear()
        self.sizes.clear()


def _gallery(torch, ctx: Ctx, p: dict):
    """(feats, windows or None): the gallery the cell serves."""
    if p["endpoint"] == "clip":
        return traffic.clip_gallery(ctx.seed, p["gallery_rows"], p["feat_dim"]), None
    qs = traffic.moment_queries(ctx.seed, p["pool"], p["feat_dim"])
    feats, windows = traffic.moment_gallery(
        torch, ctx.device, ctx.seed, traffic.video_durations(p["videos"]), qs, p["clip_sec"],
        p["max_clips"], p["planted_videos"])
    return feats, windows


def _post(url: str, body: bytes) -> dict:
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
        return json.load(r)


def run(ctx: Ctx) -> Outcome:
    import torch

    p, dev = ctx.params, ctx.device
    clip = p["endpoint"] == "clip"
    seconds = ctx.seconds if not ctx.trace else min(ctx.seconds, p["trace_seconds"])
    rate = float(p["rate"])
    proc = None
    if ctx.mode == "run":
        spec = {k: p[k] for k in ("endpoint", "pool", "k", "frames", "crop", "feat_dim", "nms",
                                  "timeout_s", "grace_s", "warm_s") if k in p}
        spec.update(seed=ctx.seed, rate=rate, seconds=seconds)
        proc = subprocess.Popen([sys.executable, LOADGEN, json.dumps(spec)],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        if ctx.mode == "control":
            result, counters, peak, setup_s, go_s = None, {}, 0, now() - ctx.t_start, 0.0
        else:
            result, counters, peak, setup_s, go_s = _serve(torch, ctx, p, proc, seconds)
    finally:
        if proc is not None:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    n = result["n"] if result else 0
    ok = [i for i in range(n) if result["status"][i] == 200]
    failed = n - len(ok)
    checks = _judge(torch, ctx, p, result, ok)
    checks.append(Check("failed_requests", float(failed), 0.0))
    for c in checks:
        c.limit = float(ctx.workload["limits"][c.name])
    out = Outcome(setup_s=setup_s, metrics={}, attempted=n, failed=failed, checks=checks,
                  memory_peak_bytes=int(peak), counters=counters, window_s=go_s)
    out.trace = counters.pop("trace", None)
    if n:
        answered = set(ok)
        lat = np.array([result["latency"][i] if i in answered else np.inf for i in range(n)])
        lat_ms = np.sort(lat) * 1e3
        out.metrics["query_p50_ms"] = float(np.percentile(lat_ms, 50))
        out.metrics["query_p95_ms"] = float(np.percentile(lat_ms, 95))
        late = np.array(result["late"])
        due = np.array(result["due"])
        halves = [np.percentile(lat[(due < seconds / 2) == h] * 1e3, 95) for h in (True, False)]
        log(f"{n} requests at {rate}/s over {seconds} s: {failed} failed; p95 of the first and "
            f"second halves {halves[0]:.2f}, {halves[1]:.2f} ms; window {go_s:.2f} s; generator "
            f"late p50 {np.median(late) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms")
    return out


def _serve(torch, ctx: Ctx, p: dict, proc, seconds: float):
    from vqwild_tpu_torch.serve.http import make_server
    from vqwild_tpu_torch.serve.index import GalleryIndex, MomentIndex
    from vqwild_tpu_torch.serve.service import QueryService

    dev, clip = ctx.device, p["endpoint"] == "clip"
    feats, windows = _gallery(torch, ctx, p)
    tracer = Tracer(torch, dev, ctx.trace)
    embed_calls = Calls(tracer, "embed")
    topk_calls = Calls(tracer, "topk")
    k1_calls = Calls(tracer, "score")
    moment_calls = Calls(tracer, "moment_query")
    embed_fn = None
    if clip:
        from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F
        from vqwild_tpu_torch.retrieval.features import make_feat_fn

        with dev:
            trunk = ResNet18F2F(bn_eps=p["bn_eps"], bn_momentum=p["bn_momentum"])
        trunk.load_state_dict(make_state(ref_arv.trunk_layout(),
                                         traffic.sub_seed(ctx.seed, traffic.ROLE_WEIGHTS), dev))
        embed_fn = embed_calls.wrap(
            make_feat_fn(trunk, wire="yuv420", dtype=torch.float32, bn_eps=p["bn_eps"],
                         device=dev), size=lambda y, uv: (y.shape[0],))
        del trunk
        meta = [{"video_id": f"g{r:05d}", "label": "a", "retrieval_type": "base"}
                for r in range(feats.shape[0])]
        index = GalleryIndex(feats, meta, device=dev)
    else:
        vid, _, _, start, end, _ = windows
        index = MomentIndex(feats.cpu().numpy(), [f"u{v:05d}" for v in range(p["videos"])],
                            vid, start, end, device=dev)
    del feats
    index.topk = topk_calls.wrap(index.topk, size=lambda q, k=30: (np.shape(q)[0],))
    index.scorer.scores = k1_calls.wrap(index.scorer.scores,
                                        size=lambda q, *a, **kw: (np.shape(q)[0],
                                                                  index.scorer.n_padded))
    if not clip:
        index.query = moment_calls.wrap(index.query, size=lambda q, **kw: (np.shape(q)[0],))
    service = QueryService(index, embed_fn=embed_fn, default_k=p["k"], max_batch=p["max_batch"],
                           max_wait_ms=p["max_wait_ms"], moment_index=None if clip else index)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        _warm(torch, ctx, p, server.server_address[1], index, embed_fn)
        if json.loads(proc.stdout.readline()).get("ready") is not True:
            raise RuntimeError("the load generator did not start")
        _tell(proc, {"port": server.server_address[1]})
        if json.loads(proc.stdout.readline()).get("warmed") is not True:
            raise RuntimeError("the load generator did not warm the server")
        for c in (embed_calls, topk_calls, k1_calls, moment_calls):
            c.reset()
        tracer.spans.clear()
        with tracer.window() as t0:
            setup_s = t0 - ctx.t_start
            _tell(proc, {"go": True})
            line = proc.stdout.readline()
            go_s = now() - t0
        if not line:
            raise RuntimeError("the load generator ended without a result")
        result = json.loads(line)
        _keep(ctx, result)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counters: Dict[str, object] = {
        "embed_s": list(embed_calls.seconds), "topk_rows": [s[0] for s in topk_calls.sizes],
        "k1_shapes": list(k1_calls.sizes), "moment_s": list(moment_calls.seconds),
        "moment_rows": [s[0] for s in moment_calls.sizes], "feat_dim": p["feat_dim"],
        "frames": p.get("frames"), "crop": p.get("crop"), "gallery_rows": index.n,
        "trace": tracer.summary}
    del index, service, server, embed_fn
    return result, counters, peak, setup_s, go_s


def _keep(ctx: Ctx, result: dict) -> None:
    """Each request's due time, latency, lateness and status, under
    portbench/.cache/runs/ (a few tens of kB a run)."""
    from portbench.harness.common import CACHE_DIR

    d = os.path.join(CACHE_DIR, "runs")
    os.makedirs(d, exist_ok=True)
    keep = {k: result[k] for k in ("due", "latency", "late", "status", "pick", "window_s")}
    with open(os.path.join(d, f"{ctx.name}-{ctx.seed}-{int(ctx.trace)}.json"), "w") as f:
        json.dump(keep, f)


def _tell(proc, msg: dict) -> None:
    proc.stdin.write(json.dumps(msg) + "\n")
    proc.stdin.flush()


def _warm(torch, ctx, p, port, index, embed_fn):
    """Every shape the traffic uses: the batch-1 embed, K1 and the sort at
    each micro-batch bucket (clip) or at one query (moments), then the
    HTTP path, one request at a time and a burst at once. The load generator
    then warms it at the cell's rate (``warm_s``)."""
    from concurrent.futures import ThreadPoolExecutor

    clip = p["endpoint"] == "clip"
    if clip:
        bodies = [traffic.npz_body(*traffic.smooth_clip(ctx.seed, i, p["frames"], p["crop"]))
                  for i in range(2)]
        y, uv = traffic.smooth_clip(ctx.seed, 0, p["frames"], p["crop"])
        embed_fn(y[None], uv[None])
        b = 1
        while b <= p["max_batch"]:
            index.topk(np.zeros((b, p["feat_dim"]), np.float32), k=p["k"])
            b *= 2
        url = f"http://127.0.0.1:{port}/query/clip?k={p['k']}"
    else:
        qs = traffic.moment_queries(ctx.seed, 2, p["feat_dim"])
        bodies = [json.dumps({"feature": q.tolist(), "k": p["k"], "nms": p["nms"]}).encode()
                  for q in qs]
        index.query(qs[:1], k=p["k"], nms_threshold=p["nms"])
        url = f"http://127.0.0.1:{port}/query/moments"
    for i in range(4):
        _post(url, bodies[i % 2])
    burst = 32 if clip else 8
    with ThreadPoolExecutor(burst) as ex:
        list(ex.map(lambda i: _post(url, bodies[i % 2]), range(2 * burst)))


def _judge(torch, ctx: Ctx, p: dict, result, ok: List[int]) -> List[Check]:
    """score_gap and rank_gap over a seeded sample of the answered requests
    (``control``: the reference in TF32 answers the same requests)."""
    dev = ctx.device
    control = ctx.mode == "control"
    r = traffic.rng(ctx.seed, traffic.ROLE_SAMPLE)
    if control:
        picks = traffic.picks(int(p["sample"]), p["pool"], ctx.seed)
        sample = list(range(len(picks)))
    else:
        picks = result["pick"]
        sample = sorted(r.choice(ok, size=min(int(p["sample"]), len(ok)), replace=False).tolist())
    if not sample:
        return [Check("score_gap", float("inf"), 0.0), Check("rank_gap", float("inf"), 0.0)]
    entries = sorted({int(picks[i]) for i in sample})
    feats, windows = _gallery(torch, ctx, p)
    g = (torch.from_numpy(feats) if isinstance(feats, np.ndarray) else feats).to(dev)
    del feats
    if p["endpoint"] == "clip":
        P = make_state(ref_arv.trunk_layout(), traffic.sub_seed(ctx.seed, traffic.ROLE_WEIGHTS),
                       dev)
        qfeat = {}
        for a in range(0, len(entries), 8):
            part = entries[a:a + 8]
            ys, uvs = zip(*(traffic.smooth_clip(ctx.seed, e, p["frames"], p["crop"])
                            for e in part))
            with torch.no_grad():
                e = ref_arv.clip_embedding(P, torch.from_numpy(np.stack(ys)).to(dev),
                                           torch.from_numpy(np.stack(uvs)).to(dev))
            for j, ent in enumerate(part):
                qfeat[ent] = e[j]
        if control:  # the same clips through the reference in TF32
            qctl = {}
            for ent in entries:
                y, uv = traffic.smooth_clip(ctx.seed, ent, p["frames"], p["crop"])
                with torch.no_grad():
                    qctl[ent] = ref_arv.clip_embedding(P, torch.from_numpy(y[None]).to(dev),
                                                       torch.from_numpy(uv[None]).to(dev),
                                                       tf32=True)[0]
    else:
        qs = traffic.moment_queries(ctx.seed, p["pool"], p["feat_dim"])
        qfeat = {e: torch.from_numpy(qs[e]).to(dev) for e in entries}
        qctl = qfeat
        vid, _, _, start, end, _ = windows
        durations = traffic.video_durations(p["videos"])
    score_gap, rank_gap = 0.0, 0.0
    with torch.no_grad():
        for i in sample:
            e = int(picks[i])
            ref_row = judge.scores(torch, qfeat[e][None], g)[0].double().cpu().numpy()
            if control:
                got_row = judge.scores(torch, qctl[e][None], g, tf32=True)[0]
                rows, got = _reference_answer(torch, p, got_row, windows)
            else:
                res = json.loads(result["replies"][i])["results"]
                got = [x["score"] for x in res]
                if p["endpoint"] == "clip":
                    rows = [int(x["video_id"][1:]) for x in res]
                else:
                    rows = traffic.window_row(
                        np.array([int(x["video_id"][1:]) for x in res], np.int64),
                        np.array([x["start_sec"] for x in res]),
                        np.array([x["end_sec"] for x in res]), durations, p["clip_sec"],
                        p["max_clips"]).tolist()
            if p["endpoint"] == "clip":
                sg, rg = judge.judge_topk(rows, got, ref_row, p["k"])
            else:
                sg, rg = judge.judge_moments(rows, got, ref_row, vid, start, end, p["k"],
                                             p["nms"], p["pool_rows"])
            score_gap, rank_gap = max(score_gap, sg), max(rank_gap, rg)
    return [Check("score_gap", score_gap, 0.0), Check("rank_gap", rank_gap, 0.0)]


def _reference_answer(torch, p, row, windows):
    """The reference's own answer from one score row: the top k, or greedy
    per-video NMS over its ``pool_rows`` best windows."""
    s = row.double().cpu().numpy()
    if p["endpoint"] == "clip":
        top = np.argsort(-s, kind="stable")[:p["k"]]
        return top.tolist(), s[top].tolist()
    vid, _, _, start, end, _ = windows
    cand = np.argsort(-s, kind="stable")[:p["pool_rows"]]
    keep: List[int] = []
    for c in cand:
        same = [j for j in keep if vid[j] == vid[c]]
        if not same or np.all(judge.iou_plus1(start[c], end[c], start[same], end[same]) < p["nms"]):
            keep.append(int(c))
            if len(keep) == p["k"]:
                break
    return keep, s[keep].tolist()
