#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) card    — name and power limit (nvidia-smi).
  (b) build   — nvcc builds csrc/sq_l2.cu (K1) and csrc/stem_pool.cu (K2),
                both started together; build seconds and ptxas usage.
  (c) k1      — K1 against its plain PyTorch version at the serving shapes
                (a full bucket of 16 queries and a single one), at an
                evaluator chunk (256 queries) and at two ragged ones:
                rtol 1e-5 / atol 1e-3 on N(0,1) data, and
                top-30 rows identical on a gallery with planted,
                well-separated neighbours (tie-free by construction). Each
                line carries the launcher's split of K and its grid. The
                bound is computed as K2's fp32 bound is.
  (d) k2      — K2 against its plain version at [960,56,56,6] (an embed
                batch): fp32 with TF32 off, atol 1e-4; bf16, atol 0.05 (one
                bf16 ULP at magnitude 2); and at [32,56,56,6] (a clip
                query) in fp32. The fp32 bound is the smaller of the fp32
                FMA time and that of three TF32 tensor-core passes, never
                under the bytes bound.
  (e) serve   — the serving path: seeded full-width trunk weights saved as
                a best.pth.tar; 16 embed batches of 30 yuv420 clips
                (32x112x112) through make_feat_fn; a 7,670-row index;
                the port's server (serve.__main__.main) on port 0 answering
                concurrent /query/features and /query/clip requests
                (p50 latency, sequential and concurrent). The launch
                counters are zeroed just before this phase and read just
                after it. Then one embed batch under torch.profiler
                (device time by kernel, busy share; line "profile") and
                the card's embeddings against the CPU path on a small
                input (1e-4).
  (f) eval    — the data layer, the building of an index and the trimmed
                evaluator, with the launch counters zeroed just before and
                read just after. A seeded trimmed DB (7,670 testing records
                over 100 labels plus distractors, a quarter of them
                queries) and its split-spec JSON are written to a temp
                directory. "eval_fake": ARVRetrievalTrimmed on seeded fake
                512-d features on the card and again with device="cpu";
                every entry of the two metric dicts within 1e-3; K1 is
                launched once per 256-query chunk; one more run under
                torch.profiler (line "profile_rank": device time by
                kernel, host waits). "eval_real": the
                server's entry point, with no index on disk, builds the
                index of the first 1,920 records from the synthetic frame
                store (64 batches of 30 clips x 32 frames x 112 x 112,
                yuv420 wire, fp32; K2 once per batch), saves it and
                answers a feature query for one of its rows with that row
                first; then ARVRetrievalTrimmed with the real extractor
                over the same records: features equal to the index's
                within 1e-5, metrics finite and in [0, 1], clips/s through
                FeatureExtractor (host work included).
  (g) kernels — one {"kernels": [...]} line; ``launches`` counts the serve
                and eval phases together.

Then the card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a GPU or a directory without the
package.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense
TF32_FLOPS = 495e12  # H100 SXM, TF32 tensor cores, dense

# the smoke's gallery at a full query bucket and at one query (a sequential
# request), a gallery four times the L2 cache, two ragged shapes
K1_SHAPES = [(16, 7670, 512), (16, 100000, 512), (1, 7670, 512), (5, 130, 512), (300, 1000, 64),
             (256, 7670, 512)]
K1_EVAL_CHUNK = (256, 7670, 512)  # one rank chunk of the trimmed evaluator
K1_BEYOND_L2 = (16, 100000, 512)  # cannot sit in L2: its time is held to its bound
# an embed batch (30 clips x 32 frames) in both types, a clip query in fp32
K2_CASES = [((960, 56, 56, 6), ("float32", "bfloat16")), ((32, 56, 56, 6), ("float32",))]
K2_ATOL = {"float32": 1e-4, "bfloat16": 0.05}
GALLERY_ROWS = 7670
EMBED_BATCHES, CLIPS, FRAMES, CROP = 16, 30, 32, 112
# the eval phase's DB: 100 labels x 72 records + 470 distractors = 7,670
EVAL_LABELS, EVAL_PER_LABEL, EVAL_QUERIES_PER_LABEL, EVAL_DISTRACTORS = 100, 72, 18, 470
EVAL_REAL_RECORDS = 1920  # 64 embed batches; no cut from the size asked for
EVAL_METRIC_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls that
    the host enqueues while the card spins, so that the calls run back to
    back and the host's launch overhead stays out of the time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of spinning, longer than the enqueueing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS, how: str = "operations"):
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the peak rate for the inputs' type, the larger."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (b, "bytes") if b >= o else (o, how)


def bound_fp32_product(nbytes: float, flops: float):
    """``bound`` for an fp32 matrix product that may run as three
    error-compensated TF32 passes on the tensor cores: the faster of that
    and the fp32 FMA pipe."""
    if 3.0 * flops / TF32_FLOPS < flops / FP32_FLOPS:
        return bound(nbytes, 3.0 * flops, TF32_FLOPS, "operations, 3xTF32")
    return bound(nbytes, flops, FP32_FLOPS, "operations, fp32 FMA")


def planted(nq: int, ng: int, d: int, gen, dev):
    """Unit query and gallery rows; each of the first min(nq, ng // 30)
    queries gets 30 gallery rows at squared distances 0.02, 0.04, .., 0.6,
    well below any random row's and 0.02 apart, so its top 30 is tie-free."""
    import torch

    q = torch.randn(nq, d, generator=gen, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    g = torch.randn(ng, d, generator=gen, device=dev)
    g /= g.norm(dim=1, keepdim=True)
    m = min(nq, ng // 30)
    rows = torch.randperm(ng, generator=gen, device=dev)[: m * 30].view(m, 30)
    u = torch.randn(m, 30, d, generator=gen, device=dev)
    u /= u.norm(dim=2, keepdim=True)
    dist = 0.02 * torch.arange(1, 31, device=dev, dtype=torch.float32)
    g[rows.reshape(-1)] = (q[:m, None] + dist.sqrt()[None, :, None] * u).reshape(-1, d)
    return q, g.contiguous(), m


def phase_k1(dev, shapes):
    import torch

    from vqwild_tpu_torch.ops.distance import launch_plan, pairwise_sq_l2, sq_l2

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for nq, ng, d in shapes:
        q = torch.randn(nq, d, generator=gen, device=dev)
        g = torch.randn(ng, d, generator=gen, device=dev)
        got, want = sq_l2(q, g), pairwise_sq_l2(q, g)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        pq, pg, m = planted(nq, ng, d, gen, dev)
        top_k = torch.sort(sq_l2(pq, pg)[:m], dim=1, stable=True).indices[:, :30]
        top_p = torch.sort(pairwise_sq_l2(pq, pg)[:m], dim=1, stable=True).indices[:, :30]
        if not torch.equal(top_k, top_p):
            raise AssertionError(f"K1 top-30 rows differ from the plain version at {(nq, ng, d)}")
        if dev.type == "cuda":
            kernel_ms = time_ms(lambda: sq_l2(q, g))
            plain_ms = time_ms(lambda: pairwise_sq_l2(q, g))
            library_ms = time_ms(
                lambda: torch.cdist(q, g, compute_mode="use_mm_for_euclid_dist") ** 2
            )
        else:
            kernel_ms = plain_ms = library_ms = None
        b_ms, b_by = bound_fp32_product(4.0 * (nq * d + ng * d + nq * ng), 2.0 * nq * ng * d)
        if kernel_ms is not None and (nq, ng, d) == K1_BEYOND_L2 and kernel_ms < b_ms:
            raise AssertionError(f"K1 {(nq, ng, d)}: {kernel_ms} ms is under its bound {b_ms}")
        row = {"phase": "k1", "shape": [nq, ng, d], "max_abs_err": err,
               "topk_queries_checked": m, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
               "launch": launch_plan(nq, ng, d) if dev.type == "cuda" else None}
        emit(row)
        rows.append(row)
    return rows


def phase_k2(dev, cases):
    import torch
    import torch.nn.functional as F

    from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool, stem_s2d_pool_plain

    rows = []
    for shape, dtypes in cases:
        n, h, w, c = shape
        gen = torch.Generator(device=dev).manual_seed(2)
        x32 = torch.randn(shape, generator=gen, device=dev)
        w32 = 0.1 * torch.randn(16 * c, 64, generator=gen, device=dev)
        b32 = 0.1 * torch.randn(64, generator=gen, device=dev)
        for name in dtypes:
            dtype, atol = getattr(torch, name), K2_ATOL[name]
            x, wm, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            got, want = stem_s2d_pool(x, wm, b), stem_s2d_pool_plain(x, wm, b)
            err = (got.float() - want.float()).abs().max().item()
            if got.shape != (n, h // 2, w // 2, 64) or not err <= atol:
                raise AssertionError(
                    f"K2 {name} {shape}: shape {tuple(got.shape)}, max err {err} > {atol}")
            if dev.type == "cuda":
                k_oihw = wm.reshape(4, 4, c, 64).permute(3, 2, 0, 1).contiguous()
                xn = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC input

                def library():
                    # symmetric pad 2, crop the last row/column == pad ((2,1),(2,1))
                    y = F.conv2d(xn, k_oihw, b, padding=2)[:, :, :h, :w]
                    return F.max_pool2d(torch.relu(y), 3, 2, padding=1)

                kernel_ms = time_ms(lambda: stem_s2d_pool(x, wm, b))
                plain_ms = time_ms(lambda: stem_s2d_pool_plain(x, wm, b))
                library_ms = time_ms(library)
            else:
                kernel_ms = plain_ms = library_ms = None
            esz = x.element_size()
            nbytes = esz * (n * h * w * c + 16 * c * 64 + 64 + n * (h // 2) * (w // 2) * 64)
            flops = 2.0 * n * h * w * 16 * c * 64
            if dtype == torch.bfloat16:
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
            else:
                b_ms, b_by = bound_fp32_product(nbytes, flops)
            if kernel_ms is not None and kernel_ms < b_ms:
                raise AssertionError(f"K2 {name} {shape}: {kernel_ms} ms is under its bound {b_ms}")
            row = {"phase": "k2", "shape": list(shape), "dtype": name,
                   "max_abs_err": err, "atol": atol, "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
                   "bound_by": b_by}
            emit(row)
            rows.append(row)
    return rows


def trunk_state_dict(seed: int):
    """Seeded full-width trunk weights in the reference checkpoint layout,
    with BN statistics that are not trivial."""
    import torch

    from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in ResNet18F2F().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            a = np.zeros((), np.int64)
        elif v.dim() == 5:  # conv [O,I,1,kh,kw]: Kaiming normal, fan_out
            a = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[3] * shape[4]))
        elif k.endswith(".weight"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(".running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # BN bias, running_mean
            a = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(np.asarray(a, np.int64 if a.dtype == np.int64 else np.float32))
    return sd


def post(url: str, body: bytes):
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
        out = json.load(r)
    return out, (time.perf_counter() - t0) * 1e3


def concurrently(fns):
    out = [None] * len(fns)
    errors = []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise TimeoutError("request thread did not finish")
    if errors:
        raise errors[0]
    return out


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run; empty if
    the profiler traced no device activity."""
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return kernels


def profile_embed(feat_fn, y, uv):
    """One embed batch under torch.profiler: device time by kernel, and the
    device's busy share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feat_fn(y, uv)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    k2_ms = sum(v for k, v in kernels.items() if "stem_pool_kernel" in k)
    return {"phase": "profile", "what": "one embed batch (30 clips x 32 frames, fp32)",
            "wall_ms": wall_ms, "device_ms": device_ms if kernels else "not traced",
            "device_busy_share": device_ms / wall_ms if kernels else "not traced",
            "stem_pool_ms": k2_ms, "n_kernel_names": len(kernels),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def phase_serve(dev, workdir, *, batches, clips, frames, crop, gallery_rows,
                ref_clips, ref_frames, n_feature_q, n_clip_q):
    import torch

    from vqwild_tpu_torch.models.convert import load_reference_checkpoint
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.retrieval.features import make_feat_fn
    from vqwild_tpu_torch.serve.__main__ import main as serve_main
    from vqwild_tpu_torch.serve.index import GalleryIndex

    ckpt = os.path.join(workdir, "best.pth.tar")
    sd = {"module." + k: v for k, v in trunk_state_dict(0).items()}
    sd["module.fc.weight"] = torch.zeros(200, 512)
    sd["module.fc.bias"] = torch.zeros(200)
    torch.save({"epoch": 0, "state_dict": sd, "score": 0.0, "optimizer": {}}, ckpt)

    rng = np.random.default_rng(3)
    ys = rng.integers(0, 256, (batches, clips, frames, crop, crop), dtype=np.uint8)
    uvs = rng.integers(0, 256, (batches, clips, frames, crop // 2, crop // 2, 2), dtype=np.uint8)

    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the main path, from here to the counter read below ----
    trunk = load_reference_checkpoint(ckpt, device=dev)
    feat_fn = make_feat_fn(trunk, wire="yuv420", dtype=torch.float32, device=dev)
    feat_fn(ys[0], uvs[0])  # warm-up (cuDNN autotune, allocator)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe = np.stack([feat_fn(ys[i], uvs[i]) for i in range(batches)])  # [batches,B,C,T]
    embed_s = time.perf_counter() - t0
    n_clips = batches * clips
    if fe.shape != (batches, clips, 512, frames) or not np.isfinite(fe).all():
        raise AssertionError(f"embeddings: shape {fe.shape}, finite {np.isfinite(fe).all()}")
    norms = np.linalg.norm(fe, axis=2)
    if not np.allclose(norms, 1.0, atol=1e-4):
        raise AssertionError("frame embeddings are not unit-norm")

    clip_feats = fe.mean(axis=3).reshape(n_clips, 512)
    pad = rng.standard_normal((gallery_rows - n_clips, 512)).astype(np.float32)
    pad /= np.linalg.norm(pad, axis=1, keepdims=True)
    feats = np.concatenate([clip_feats, pad]).astype(np.float32)
    meta = [{"video_id": f"v{i:05d}", "label": f"cls{i % 200}", "retrieval_type": "base"}
            for i in range(gallery_rows)]
    index_dir = os.path.join(workdir, "index")
    GalleryIndex(feats, meta, device=dev).save(index_dir)

    ready = threading.Event()
    holder = {}

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = ["--index_dir", index_dir, "--test_load", ckpt, "--port", "0",
            "--device", str(dev), "--dtype", "float32", "--max_wait_ms", "5"]
    srv_thread = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
    srv_thread.start()
    if not ready.wait(timeout=300):
        raise TimeoutError("server did not start")
    server = holder["server"]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        feat_rows = list(range(0, gallery_rows, max(1, gallery_rows // n_feature_q)))[:n_feature_q]
        clip_ids = [(i * 7) % n_clips for i in range(n_clip_q)]

        def feat_req(r):
            body, ms = post(f"{base}/query/features",
                            json.dumps({"feature": feats[r].tolist(), "k": 30}).encode())
            res = body["results"]
            if len(res) != 30 or res[0]["video_id"] != meta[r]["video_id"]:
                raise AssertionError(f"feature query for row {r} answered {res[:1]}")
            return ms

        def clip_req(cid):
            bi, ci = divmod(cid, clips)
            buf = io.BytesIO()
            np.savez(buf, y=ys[bi, ci], uv=uvs[bi, ci])
            body, ms = post(f"{base}/query/clip?k=10", buf.getvalue())
            top = body["results"][0]
            if top["video_id"] != meta[cid]["video_id"] or top["score"] < -1e-3:
                raise AssertionError(f"clip {cid} answered {top}")
            return ms

        latency = {}
        for kind, ids, req in (("feature", feat_rows, feat_req), ("clip", clip_ids, clip_req)):
            # an untimed concurrent round first: each client thread's first
            # GPU call makes its cuDNN/cuBLAS handles, and the first 32-frame
            # embed picks its conv algorithms
            concurrently([(lambda i=i: req(i)) for i in ids])
            seq = [req(i) for i in ids]
            conc = concurrently([(lambda i=i: req(i)) for i in ids])
            latency[f"{kind}_query_p50_ms_sequential"] = float(np.median(seq))
            latency[f"{kind}_query_p50_ms_concurrent"] = float(np.median(conc))
    finally:
        server.shutdown()
        srv_thread.join(timeout=60)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    # ---- end of the main path ----

    if dev.type == "cuda":
        emit(profile_embed(feat_fn, ys[0], uvs[0]))

    # the card's embeddings against the CPU path (plain K2, CPU convs) on a
    # small input, fp32 both: tolerance 1e-4 as in the CPU tests
    ref_fn = make_feat_fn(load_reference_checkpoint(ckpt, device="cpu"), wire="yuv420",
                          dtype=torch.float32, device="cpu")
    ry, ruv = ys[0, :ref_clips, :ref_frames], uvs[0, :ref_clips, :ref_frames]
    ref_err = float(np.abs(feat_fn(ry, ruv) - ref_fn(ry, ruv)).max())
    if ref_err > 1e-4:
        raise AssertionError(f"card embeddings differ from the CPU path by {ref_err}")

    row = {
        "phase": "serve", "embed_clips_per_s": n_clips / embed_s,
        "embed_batches": batches, "clips_per_batch": clips, "frames": frames, "crop": crop,
        "gallery_rows": gallery_rows, "feature_queries": len(feat_rows),
        "clip_queries": len(clip_ids), **latency,
        "self_query_rank0": True, "ref_max_abs_err": ref_err, "launches": launches,
    }
    emit(row)
    if dev.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    return row


def write_trimmed_db(workdir, *, labels, per_label, queries_per_label, distractors, seed):
    """A seeded trimmed DB in the arv_db_*.json schema and its split-spec
    JSON. The ``testing`` split holds ``per_label`` records for each of
    ``labels`` classes (80% base, 20% test-novel; ``queries_per_label`` of
    them is_query=1) and ``distractors`` noise records after the fifth
    class, every record a video of its own. Returns the spec's path."""
    rng = np.random.default_rng(seed)
    names = [f"activity_{i:03d}" for i in range(labels)]
    n_base = labels * 4 // 5
    serial = iter(range(10**9))

    def record(label, rtype, is_query):
        start = float(rng.uniform(0.0, 5.0))
        seg = [start, start + float(rng.uniform(8.0, 14.0))]
        return {"video_id": f"v_{next(serial):07d}", "label": label, "segment": seg,
                "border": seg, "activitynet_subset": "validation",
                "activitynet_duration": 64 / 3, "is_query": is_query, "retrieval_type": rtype}

    testing = {}
    for i, name in enumerate(names):
        if i == 5:
            testing["distractor_activity"] = [
                record("distractor_activity", "noise", -1) for _ in range(distractors)]
        rtype = "base" if i < n_base else "novel"
        testing[name] = [record(name, rtype, 1 if j < queries_per_label else 0)
                         for j in range(per_label)]
    with open(os.path.join(workdir, "arv_db_smoke.json"), "w") as f:
        json.dump({"training": {}, "validation": {}, "testing": testing}, f)
    spec = os.path.join(workdir, "split_smoke.json")
    with open(spec, "w") as f:
        json.dump({"name": "smoke", "train_labels": names[:n_base], "val_labels": [],
                   "test_labels": names[n_base:], "db_json": "arv_db_smoke.json",
                   "moment_db_json": ""}, f)
    return spec


def tree_max_diff(a, b, path="result"):
    """Largest |a - b| over two metric dicts of one structure; raises on a
    structural difference or a value that is not finite."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise AssertionError(f"{path}: keys differ")
        return max([tree_max_diff(a[k], b[k], f"{path}[{k!r}]") for k in a], default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        return max([tree_max_diff(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))],
                   default=0.0)
    if isinstance(a, (str, bool, type(None))):
        if a != b:
            raise AssertionError(f"{path}: {a!r} != {b!r}")
        return 0.0
    if not (np.isfinite(a) and np.isfinite(b)):
        raise AssertionError(f"{path}: {a} / {b} is not finite")
    return abs(float(a) - float(b))


def tree_numbers(a):
    if isinstance(a, dict):
        a = list(a.values())
    if isinstance(a, (list, tuple)):
        return [x for v in a for x in tree_numbers(v)]
    return [] if isinstance(a, (str, bool, type(None))) else [float(a)]


def profile_rank(evaluate):
    """One evaluator run on fake features under torch.profiler: the rank
    loop's device time by kernel, and how often the host waited for the
    device (the profiler's own overhead inflates the host times, so only
    device times and counts are reported)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        evaluate()
        torch.cuda.synchronize()
    kernels = device_ms_by_kernel(prof)
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
                          "cudaLaunchKernel")}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"phase": "profile_rank", "what": "the evaluator on fake features, 8 chunks of 256",
            "device_ms": sum(kernels.values()) if kernels else "not traced",
            "sq_l2_ms": sum(v for k, v in kernels.items() if "sq_l2_kernel" in k),
            "n_kernel_names": len(kernels), "runtime_calls": calls,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def phase_eval(dev, workdir, ckpt, *, labels, per_label, queries_per_label, distractors,
               real_records, clips, frames, crop, feat_dim=512, rank_chunk=256):
    import torch

    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_trimmed_db
    from vqwild_tpu_torch.models.convert import load_reference_checkpoint
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.retrieval import (
        ARVRetrievalTrimmed, FeatureExtractor, make_fake_feat_fn, make_feat_fn,
    )
    from vqwild_tpu_torch.serve.__main__ import main as serve_main

    def counts():
        return {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    spec_path = write_trimmed_db(workdir, labels=labels, per_label=per_label,
                                 queries_per_label=queries_per_label,
                                 distractors=distractors, seed=5)
    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the eval path, from here to the counter read at the end ----
    spec = get_split(spec_path)
    db = load_trimmed_db(spec.db_json)
    n_records = len(db.flat("testing"))

    # (a) seeded fake features: the card against the CPU path
    def fake_eval(device):
        ex = FeatureExtractor(make_fake_feat_fn(feat_dim, seed=6), SyntheticFrameStore(),
                              test_frames=frames, test_batch_size=clips, fake=True)
        ev = ARVRetrievalTrimmed(db, spec, ex, eval_split="testing", rank_chunk=rank_chunk,
                                 device=device)
        t0 = time.perf_counter()
        result = ev.evaluation()
        return result, ev.timings, time.perf_counter() - t0

    before = counts()
    fake_eval(dev)  # warm-up: the first sort and cumulative ops load their kernels
    sync()
    got, timings, wall_s = fake_eval(dev)
    fake_launches = since(before)
    want, cpu_timings, cpu_wall_s = fake_eval("cpu")
    n_queries = labels * queries_per_label
    n_chunks = -(-n_queries // rank_chunk)
    diff = tree_max_diff(got, want)
    emit({"phase": "eval_fake", "records": n_records, "labels": labels + 1,
          "queries": n_queries, "chunks": n_chunks, "rank_chunk": rank_chunk,
          "feat_dim": feat_dim, "metrics_max_abs_diff_vs_cpu": diff, "tol": EVAL_METRIC_TOL,
          "ap": got["ap"], "o1_class_agnostic_map": got["o1_class_agnostic_map"],
          "timings_s": timings, "wall_s": wall_s, "cpu_timings_s": cpu_timings,
          "cpu_wall_s": cpu_wall_s, "launches_two_runs": fake_launches})
    if not diff <= EVAL_METRIC_TOL:
        raise AssertionError(f"card and CPU metrics differ by {diff} > {EVAL_METRIC_TOL}")
    if dev.type == "cuda" and fake_launches != {"sq_l2": 2 * n_chunks, "stem_s2d_pool": 0}:
        raise AssertionError(f"eval_fake: launches {fake_launches}, expected K1 once per chunk "
                             f"({n_chunks} chunks, two runs)")
    if dev.type == "cuda":
        emit(profile_rank(lambda: fake_eval(dev)))

    # (b) the server builds, saves and serves the index of the first
    # ``real_records`` records; then the evaluator with the real extractor
    index_dir = os.path.join(workdir, "eval_index")
    ready = threading.Event()
    holder = {}

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = ["--index_dir", index_dir, "--test_load", ckpt, "--port", "0", "--device", str(dev),
            "--dtype", "float32", "--meta_split", spec_path, "--frame_store", "synthetic",
            "--eval_split", "testing", "--max_gallery", str(real_records),
            "--input_size", str(crop), "--test_frame", str(frames),
            "--test_batch_size", str(clips)]
    before = counts()
    t0 = time.perf_counter()
    srv_thread = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
    srv_thread.start()
    if not ready.wait(timeout=900):
        raise TimeoutError("server did not build its index")
    build_s = time.perf_counter() - t0
    server = holder["server"]
    try:
        feats = np.load(os.path.join(index_dir, "feats.npy"))
        with open(os.path.join(index_dir, "meta.json")) as f:
            meta = json.load(f)
        row = real_records // 3
        body, _ = post(f"http://127.0.0.1:{server.server_address[1]}/query/features",
                       json.dumps({"feature": feats[row].tolist(), "k": 10}).encode())
        top = body["results"][0]
        if top["video_id"] != meta[row]["video_id"] or top["rank"] != 0:
            raise AssertionError(f"feature query for built row {row} answered {top}")
    finally:
        server.shutdown()
        srv_thread.join(timeout=60)
    build_launches = since(before)
    n_batches = -(-real_records // clips)
    norms = np.linalg.norm(feats, axis=1)
    if (feats.shape != (real_records, feat_dim) or not np.isfinite(feats).all()
            or norms.max() > 1.0 + 1e-4 or norms.min() < 0.1):
        raise AssertionError(f"built index: shape {feats.shape}, norms {norms.min()}..{norms.max()}")

    before = counts()
    feat_fn = make_feat_fn(load_reference_checkpoint(ckpt, device=dev), wire="yuv420",
                           dtype=torch.float32, device=dev)
    ex = FeatureExtractor(feat_fn, SyntheticFrameStore(), test_frames=frames,
                          test_batch_size=clips, input_size=crop, wire="yuv420",
                          max_batches=n_batches, cache_dir=os.path.join(workdir, "eval_cache"))
    ev = ARVRetrievalTrimmed(db, spec, ex, eval_split="testing", rank_chunk=rank_chunk,
                             device=dev)
    result = ev.evaluation()
    sync()
    real_launches = since(before)
    ev_feats = np.load(os.path.join(workdir, "eval_cache", "trimmed_testing_feats", "feats.npy"))
    feats_err = float(np.abs(ev_feats[:real_records] - feats).max())
    numbers = tree_numbers(result)
    real_queries = sum(1 for r in ev.records if r.is_query == 1 and r.retrieval_type != "noise")
    real_chunks = -(-real_queries // rank_chunk)
    launches = counts()
    # ---- end of the eval path ----
    emit({"phase": "eval_real", "records": real_records, "records_asked_for": EVAL_REAL_RECORDS,
          "embed_batches": n_batches, "clips_per_batch": clips, "frames": frames, "crop": crop,
          "index_build_s": build_s, "index_build_clips_per_s": real_records / build_s,
          "evaluator_records": len(ev.records),
          "extractor_clips_per_s": len(ev.records) / ev.timings["features"],
          "timings_s": ev.timings, "queries": real_queries, "chunks": real_chunks,
          "feats_max_abs_diff_vs_index": feats_err, "feat_norm_min": float(norms.min()),
          "feat_norm_max": float(norms.max()), "ap": result["ap"],
          "o1_class_agnostic_map": result["o1_class_agnostic_map"],
          "self_query_rank0": True, "launches_build_and_query": build_launches,
          "launches_evaluator": real_launches, "launches": launches})
    if len(ev.records) != min(n_batches * clips, n_records) or feats_err > 1e-5:
        raise AssertionError(f"evaluator features differ from the index's by {feats_err}")
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"eval_real metrics outside [0, 1]: {result}")
    if dev.type == "cuda":
        if (build_launches["stem_s2d_pool"] < n_batches or build_launches["sq_l2"] < 1
                or real_launches["stem_s2d_pool"] < n_batches
                or real_launches["sq_l2"] != real_chunks):
            raise AssertionError(f"eval_real launches: build {build_launches}, evaluator "
                                 f"{real_launches}; {n_batches} batches, {real_chunks} chunks")
    return {"launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vqwild_tpu_torch.core.device import disable_tf32
    from vqwild_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    disable_tf32()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    secs = _build.build(["sq_l2", "stem_pool"])
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in secs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_kernel_s": secs,
          "ptxas": ptxas})

    k1 = phase_k1(dev, K1_SHAPES)
    k2 = phase_k2(dev, K2_CASES)
    with tempfile.TemporaryDirectory() as workdir:
        serve = phase_serve(dev, workdir, batches=EMBED_BATCHES, clips=CLIPS, frames=FRAMES,
                            crop=CROP, gallery_rows=GALLERY_ROWS, ref_clips=2, ref_frames=4,
                            n_feature_q=32, n_clip_q=8)
        evald = phase_eval(dev, workdir, os.path.join(workdir, "best.pth.tar"),
                           labels=EVAL_LABELS, per_label=EVAL_PER_LABEL,
                           queries_per_label=EVAL_QUERIES_PER_LABEL,
                           distractors=EVAL_DISTRACTORS, real_records=EVAL_REAL_RECORDS,
                           clips=CLIPS, frames=FRAMES, crop=CROP)

    k1_main = k1[0]  # (16, 7670, 512): the smoke's gallery at a full query bucket
    k1_eval = next(r for r in k1 if tuple(r["shape"]) == K1_EVAL_CHUNK)
    k2_main = k2[0]  # an embed batch in fp32, the serving dtype
    launches = {k: serve["launches"][k] + evald["launches"][k] for k in serve["launches"]}
    emit({"kernels": [
        {"name": "sq_l2", "route": "cuda", "source": "vqwild_tpu_torch/csrc/sq_l2.cu",
         "replaces": "vqwild_tpu/ops/pallas_kernels.py:53",
         "launches": launches["sq_l2"],
         "launches_by_path": {"serve": serve["launches"]["sq_l2"],
                              "eval": evald["launches"]["sq_l2"]},
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": k1_main["kernel_ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"].split(",")[0],
         "library_ms": k1_main["library_ms"], "shape": k1_main["shape"],
         "eval_chunk": {k: k1_eval[k] for k in ("shape", "kernel_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}},
        {"name": "stem_s2d_pool", "route": "cuda", "source": "vqwild_tpu_torch/csrc/stem_pool.cu",
         "replaces": "vqwild_tpu/ops/pallas_kernels.py:152",
         "launches": launches["stem_s2d_pool"],
         "launches_by_path": {"serve": serve["launches"]["stem_s2d_pool"],
                              "eval": evald["launches"]["stem_s2d_pool"]},
         "max_abs_err": k2_main["max_abs_err"],
         "ms": k2_main["kernel_ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"].split(",")[0],
         "library_ms": k2_main["library_ms"], "shape": k2_main["shape"], "dtype": "float32"},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
