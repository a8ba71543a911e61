#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) card    — name and power limit (nvidia-smi).
  (b) build   — nvcc builds csrc/sq_l2.cu (K1) and csrc/stem_pool.cu (K2),
                both started together; build seconds and ptxas usage.
  (c) k1      — K1 against its plain PyTorch version at the serving shapes
                (a full bucket of 16 queries and a single one), at a rank
                chunk of the trimmed (256 queries), clip (256) and moment
                (128) evaluators and of the moment device engine (32 against
                1,466,542 rows), and at two ragged ones:
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
  (g) clip    — the untrimmed clip regime, with the launch counters zeroed
                just before and read just after. A seeded moment DB is
                written to a temp directory: 4,900 gallery videos (the size
                of ActivityNet v1.3's validation split) of 60-230 s, 1-2
                annotations each, and 1,800 queries over 100 labels (8
                chunks of 256). "clip_fake": ARVRetrievalClip on seeded fake
                512-d features over ~98,000 clip windows of 6 s (tapes from
                a frame store that only knows each video's length): metrics
                finite and in [0, 1], K1 once per chunk, its five timings;
                one more run under torch.profiler (line "profile_rank_clip":
                device ms by kernel, K1's share of the rank loop, launches,
                synchronisations, host against device time); the first
                tenth of the videos on the card and with device="cpu",
                every entry of the two metric dicts within 1e-3.
                "clip_real": the server's entry point, with no index on
                disk, builds the clip index of 64 videos from the synthetic
                frame store (64 frames each: 128 chunks, 5 embed batches,
                K2 once per batch), saves it and answers a feature query
                for one of its rows with that row first and its loc_sec;
                then ARVRetrievalClip with the real extractor over the same
                videos: gallery features equal to the index's within 1e-5,
                clips/s of extract_video_tapes.
  (h) moment  — the untrimmed moment regime on both engines, with the
                launch counters zeroed just before and read just after. The
                clip phase's moment DB (4,900 videos). "moment_fake":
                ARVRetrievalMoment on seeded fake 512-d features over every
                moment window of 1-26 x 5 s (1,466,542 windows, a 3.0 GB
                gallery), the queries cut to 512 (4 chunks of 128; printed
                as ``reduced``): the native C++ postprocess must be the
                engine, K1 once per chunk, metrics finite and in [0, 1],
                the seven timings, GB of gallery and of score readback;
                then the first tenth of the videos on the card and with
                device="cpu" (256 queries), every metric within 1e-3.
                "moment_device": the device engine (engine="device": NMS
                and grouped-order AP as torch ops, K1 once per chunk of 32,
                16 chunks in one super-chunk) on the same 512 queries over
                the gallery moment_fake built and kept: every metric within
                1e-3 of the host engine's, its timings and ranking seconds
                beside the host engine's readback + postprocess, peak device
                memory, the bucket plan; at the tenth of the videos within
                1e-3 of the CPU host engine's metrics; then one chunk under
                torch.profiler (line "profile_moment_device": device ms by
                kernel, K1's, the spans of the scoring, bucket-sort, NMS
                and AP-sort ranges, launches, synchronising calls, busy
                share).
                "moment_serve": a MomentIndex of those 1.47M windows behind
                the port's HTTP server; /query/moments (k = 10) for 32
                short windows' own features, sequential and 8-way
                concurrent: each window back at rank 0, p50 latency; the
                pool's top-k (4,096 of 1.47M) by the full stable sort and
                by torch.topk + a stable sort of the pool, timed at B = 1
                and 16 and held equal; one chunk's [128, G] scores read
                back into pageable and into pinned memory, and the native
                postprocess of 16 of its rows on 1 and on 8 threads (line
                "moment_serve", key moment_host_costs). "moment_real": the
                server's entry point with --regime moment and no index on
                disk builds the moment index of 64 videos from the
                synthetic frame store (K2 once per embed batch) and saves
                it; the most distinct window's own feature brings it back
                at rank 0; a second server loads the saved index
                (--no_embed) and answers identically; then
                ARVRetrievalMoment with the real extractor over the same
                videos (engine "auto": the device engine on the card):
                gallery features equal to the index's within 1e-5.
  (i) train   — the train step (vqwild_tpu_torch/train/step.py) at full
                width, run right after k2, with the launch counters zeroed
                just before and read just after (it launches neither K1 nor
                K2; "train": 0 in the kernels line). ResNet18-F2F, 200
                classes, 512-d, a batch of 10 triplets = 30 clips x 32 x
                112x112 uint8 (960 frames) on the card, seeded labels with
                repeats: for baseline, va and vasa (vasa with a seeded
                [200, 200] word memory), 2 warm-up and 10 timed Adam steps in
                fp32 (TF32 off), the same in bf16, one fp32 step on the
                yuv420 wire; a line each with ms a step (median, min, max),
                clips/s, frames/s, peak device memory and every step's
                losses, all finite. "train_vs_cpu": 3 va steps at B 6,
                T 2, 32x32 on the card and on the CPU from the same weights
                and batches, each card step from the CPU's state after the
                step before, held to TRAIN_VS_CPU_TOL. "profile_train": one
                fp32 va step under torch.profiler: the top ten device
                operations and the share of cuDNN convolutions forward and
                backward.
  (j) kernels — one {"kernels": [...]} line; ``launches`` counts the serve,
                eval, clip, moment and train phases together.

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
# request), a gallery four times the L2 cache, two ragged shapes, a rank
# chunk of the trimmed, of the clip and of the moment evaluator
K1_EVAL_CHUNK = (256, 7670, 512)  # one rank chunk of the trimmed evaluator
K1_CLIP_CHUNK = (256, 100000, 512)  # one rank chunk of the clip evaluator
# one rank chunk of the moment evaluator over the moment phase's gallery:
# every window of 1-26 x 5 s of the 4,900 videos (phase_moment checks the count)
K1_MOMENT_CHUNK = (128, 1466542, 512)
# one chunk of the moment evaluator's device engine (32 queries) over it
K1_MOMENT_DEVICE_CHUNK = (32, 1466542, 512)
K1_SHAPES = [(16, 7670, 512), (16, 100000, 512), (1, 7670, 512), (5, 130, 512), (300, 1000, 64),
             K1_EVAL_CHUNK, K1_CLIP_CHUNK, K1_MOMENT_CHUNK, K1_MOMENT_DEVICE_CHUNK]
# galleries that cannot sit in L2: their times are held to their bounds
K1_BEYOND_L2 = ((16, 100000, 512), K1_CLIP_CHUNK, K1_MOMENT_CHUNK, K1_MOMENT_DEVICE_CHUNK)
# an embed batch (30 clips x 32 frames) in both types, a clip query in fp32
K2_CASES = [((960, 56, 56, 6), ("float32", "bfloat16")), ((32, 56, 56, 6), ("float32",))]
K2_ATOL = {"float32": 1e-4, "bfloat16": 0.05}
GALLERY_ROWS = 7670
EMBED_BATCHES, CLIPS, FRAMES, CROP = 16, 30, 32, 112
# the eval phase's DB: 100 labels x 72 records + 470 distractors = 7,670
EVAL_LABELS, EVAL_PER_LABEL, EVAL_QUERIES_PER_LABEL, EVAL_DISTRACTORS = 100, 72, 18, 470
EVAL_REAL_RECORDS = 1920  # 64 embed batches; no cut from the size asked for
EVAL_METRIC_TOL = 1e-3
# the clip phase's moment DB: ActivityNet v1.3 validation has 4,926 videos;
# 1,800 queries over 100 labels; the synthetic store's 64 frames a video
# make 2 chunks each, so 64 videos give 128 chunks (5 embed batches)
CLIP_VIDEOS, CLIP_QUERIES, CLIP_LABELS, CLIP_SEC = 4900, 1800, 100, 6
CLIP_REAL_VIDEOS = 64
# the moment phase: the clip phase's DB, windows of 1..26 x 5 s; the 1,800
# queries cut to 512 (4 chunks of 128) to bound the host postprocess
MOMENT_CLIP_SEC, MOMENT_MAX_CLIPS, MOMENT_QUERY_CAP, MOMENT_REAL_VIDEOS = 5, 26, 512, 64
# the device engine's chunk (ARVRetrievalMoment: min(rank_chunk, 32)) and its
# super-chunk (the evaluator's default scan_chunks)
MOMENT_DEVICE_CHUNK, MOMENT_SCAN_CHUNKS = 32, 16
# the train step at the JAX package's defaults (core/config.py): 10 triplets
# of 32 x 112x112 clips a step, 200 classes, 200-d word embeddings
TRAIN_TRIPLETS, TRAIN_NCLASS, TRAIN_SEM_DIM = 10, 200, 200
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
# card against CPU, 3 va steps at B 6, T 2, 32x32, each card step from the
# CPU's state: losses 1e-3 (5e-4 is the JAX test's one-step bound), BN
# running means 1e-4 and variances 1e-2 relative, the memory 1e-4, every
# parameter within an Adam step's 2·lr, and at most 0.5% of the elements
# with a resolved gradient beyond 1e-5 (the JAX tests allow 0.2%), over all
# parameters and over the non-local block's alone
TRAIN_VS_CPU_TOL = {"loss": 1e-3, "bn_mean": 1e-4, "bn_var_rel": 1e-2, "memory": 1e-4,
                    "resolved_share_over_1e-5": 5e-3,
                    "non_local_resolved_share_over_1e-5": 5e-3}
# gradients that are 0 in exact arithmetic (the softmax is blind to φ's bias;
# the train-mode W-BN removes W's bias): held to the 2·lr bound only
ZERO_GRADS = ("cls_nl.phi.bias", "cls_nl.W.0.bias")


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
        if kernel_ms is not None and (nq, ng, d) in K1_BEYOND_L2 and kernel_ms < b_ms:
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


ANNOTATION = "moment_device."  # the device engine's record_function ranges


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run; empty if
    the profiler traced no device activity."""
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and not e.key.startswith(ANNOTATION):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return kernels


def annotation_ms(prof) -> dict:
    """The device engine's ranges from a torch.profiler run: for each, its
    span on the device's timeline in ms (the GPU annotation: from its first
    kernel's start to its last kernel's end, idle gaps included, summed over
    its calls) and its calls."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith(ANNOTATION) and str(e.device_type).endswith("CUDA"):
            out[e.key[len(ANNOTATION):]] = {"span": e.device_time_total / 1e3, "calls": e.count}
    return out


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


def profile_rank(evaluate, name="profile_rank",
                 what="the evaluator on fake features, 8 chunks of 256"):
    """One evaluator run on fake features under torch.profiler: the rank
    loop's device time by kernel, K1's share of it, and how often the host
    launched and waited (the profiler's own overhead inflates host times,
    so the host's rank time is reported beside the device's as read in this
    run). ``evaluate()`` returns the evaluator's timings. The rank loop's
    device time is all device time but the host-to-device copies (the
    gallery and query uploads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timings = evaluate()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
                          "cudaLaunchKernel")}
    copies = {e.key: [str(e.device_type), e.self_device_time_total / 1e3, e.count]
              for e in prof.key_averages() if "Memcpy" in e.key}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    device_ms = sum(kernels.values())
    htod_ms = sum(v for k, v in kernels.items() if k.startswith("Memcpy HtoD"))
    sq_l2_ms = sum(v for k, v in kernels.items() if "sq_l2_kernel" in k)
    rank_ms = device_ms - htod_ms
    return {"phase": name, "what": what,
            "device_ms": device_ms if kernels else "not traced",
            "memcpy_htod_ms": htod_ms, "rank_loop_device_ms": rank_ms,
            "sq_l2_ms": sq_l2_ms, "sq_l2_share_of_rank_loop": sq_l2_ms / rank_ms if rank_ms else None,
            "rank_loop_host_ms": 1e3 * (timings["rank_dispatch"] + timings["metrics_readback"]),
            "wall_ms": wall_ms, "n_kernel_names": len(kernels), "runtime_calls": calls,
            "copies": copies,
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
        emit(profile_rank(lambda: fake_eval(dev)[1]))

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


def write_moment_db(workdir, *, videos, queries, labels, seed):
    """A seeded moment DB in the arv_db_*_untrimmed.json schema, an empty
    trimmed DB, and their split-spec JSON. The gallery holds ``videos``
    untrimmed videos of 60-230 s (60 + 170 x Beta(1.5, 2.75): mean 120 s,
    skewed short as ActivityNet's are), each with 1-2 annotations of random
    labels over 10-60% of the video; ``queries`` trimmed query clips spread
    evenly over ``labels`` classes (80% base, 20% test-novel), and 20 noise
    queries that the evaluator drops. Returns the spec's path and each
    gallery video's frame count at 3 fps."""
    rng = np.random.default_rng(seed)
    names = [f"activity_{i:03d}" for i in range(labels)]
    n_base = labels * 4 // 5
    gallery, frames = [], {}
    for i in range(videos):
        dur = float(60.0 + 170.0 * rng.beta(1.5, 2.75))
        anns = []
        for _ in range(int(rng.integers(1, 3))):
            length = dur * float(rng.uniform(0.1, 0.6))
            start = float(rng.uniform(0.0, dur - length))
            anns.append({"segment": [start, start + length],
                         "label": names[int(rng.integers(labels))]})
        vid = f"g_{i:06d}"
        gallery.append({"video_id": vid, "label": "", "segment": [0.0, dur],
                        "border": [0.0, dur], "activitynet_subset": "validation",
                        "activitynet_duration": dur, "is_query": 0, "retrieval_type": "",
                        "annotations": anns})
        frames[vid] = int(dur * 3)
    query = []
    for j in range(queries + 20):
        noise = j >= queries
        start = float(rng.uniform(0.0, 5.0))
        seg = [start, start + float(rng.uniform(8.0, 14.0))]
        query.append({"video_id": f"q_{j:06d}", "label": "distractor" if noise else names[j % labels],
                      "segment": seg, "border": seg, "activitynet_subset": "validation",
                      "activitynet_duration": 64 / 3, "is_query": 1,
                      "retrieval_type": "noise" if noise else
                      ("base" if j % labels < n_base else "novel")})
    with open(os.path.join(workdir, "arv_db_clip_untrimmed.json"), "w") as f:
        json.dump({"query": query, "gallery": gallery}, f)
    with open(os.path.join(workdir, "arv_db_clip.json"), "w") as f:
        json.dump({"training": {}, "validation": {}, "testing": {}}, f)
    spec = os.path.join(workdir, "split_clip.json")
    with open(spec, "w") as f:
        json.dump({"name": "clip", "train_labels": names[:n_base], "val_labels": [],
                   "test_labels": names[n_base:], "db_json": "arv_db_clip.json",
                   "moment_db_json": "arv_db_clip_untrimmed.json"}, f)
    return spec, frames


def length_store(frames_by_video):
    """A synthetic frame store whose videos have the given frame counts
    (all that fake features need of a store)."""
    from vqwild_tpu_torch.data.frames import SyntheticFrameStore

    class LengthStore(SyntheticFrameStore):
        def num_frames(self, subset, video_id):
            return frames_by_video[video_id]

    return LengthStore()


def phase_clip(dev, workdir, ckpt, *, videos, queries, labels, real_videos, clips, frames,
               crop, clip_sec, feat_dim=512, rank_chunk=256):
    import torch

    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_moment_db
    from vqwild_tpu_torch.models.convert import load_reference_checkpoint
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.retrieval import (
        ARVRetrievalClip, FeatureExtractor, make_fake_feat_fn, make_feat_fn,
    )
    from vqwild_tpu_torch.serve.__main__ import main as serve_main

    def counts():
        return {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    spec_path, video_frames = write_moment_db(workdir, videos=videos, queries=queries,
                                              labels=labels, seed=8)
    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the clip path, from here to the counter read at the end ----
    spec = get_split(spec_path)
    mdb = load_moment_db(spec.moment_db_json)
    n_queries = len(mdb.nonnoise_queries())
    n_chunks = -(-n_queries // rank_chunk)
    cache_dir = os.path.join(workdir, "clip_cache")

    def timed(fn, key, spent):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    # (a) seeded fake features over the whole gallery; the host seconds of
    # the tapes and of the cache write are read apart from gallery_build's
    def fake_eval(device, gallery=None, **kw):
        ex = FeatureExtractor(make_fake_feat_fn(feat_dim, seed=9), length_store(video_frames),
                              test_frames=frames, test_batch_size=clips, fake=True, **kw)
        spent = {}
        ex.extract_video_tapes = timed(ex.extract_video_tapes, "tapes", spent)
        ex.save_cache = timed(ex.save_cache, "cache_write", spent)
        ev = ARVRetrievalClip(mdb, spec, ex, clip_sec=clip_sec, rank_chunk=rank_chunk,
                              device=device, read_cache=kw.get("cache_dir") is not None)
        if gallery is not None:
            ev.gallery_videos = ev.gallery_videos[:gallery]
        t0 = time.perf_counter()
        result = ev.evaluation()
        return result, ev.timings, time.perf_counter() - t0, spent

    before = counts()
    if os.path.isdir(cache_dir):
        raise AssertionError(f"{cache_dir} exists before the first run")
    got, timings, wall_s, spent = fake_eval(dev, cache_dir=cache_dir)  # builds, saves the gallery
    sync()
    fake_launches = since(before)
    gal = np.load(os.path.join(cache_dir, "clip_gallery", "feats.npy"), mmap_mode="r")
    n_windows = gal.shape[0]
    numbers = tree_numbers(got)
    n_tape_chunks = sum(-(-f // frames) for f in video_frames.values())
    arena_gb = n_tape_chunks * frames * feat_dim * 4 / 1e9
    build_split = {"tapes": spent["tapes"], "cache_write": spent["cache_write"],
                   "windows_pool_label": timings["gallery_build"] - sum(spent.values())}
    row = {"phase": "clip_fake", "gallery_videos": videos, "clip_windows": n_windows,
           "clip_sec": clip_sec, "tape_arena_gb": arena_gb, "queries": n_queries,
           "chunks": n_chunks, "rank_chunk": rank_chunk, "feat_dim": feat_dim,
           "ap": got["ap"], "o1_class_agnostic_map": got["o1_class_agnostic_map"],
           "timings_s": timings, "gallery_build_split_s": build_split,
           "tape_chunks": n_tape_chunks, "tapes_clips_per_s": n_tape_chunks / spent["tapes"],
           "wall_s": wall_s,
           "rank_loop_host_ms": 1e3 * (timings["rank_dispatch"] + timings["metrics_readback"]),
           "launches": fake_launches}
    emit(row)
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"clip_fake metrics outside [0, 1]: {got}")
    if set(timings) != {"query_feats", "gallery_build", "gallery_to_device", "rank_dispatch",
                        "metrics_readback"}:
        raise AssertionError(f"clip_fake timings: {sorted(timings)}")
    if dev.type == "cuda" and fake_launches != {"sq_l2": n_chunks, "stem_s2d_pool": 0}:
        raise AssertionError(f"clip_fake: launches {fake_launches}, expected K1 once per chunk "
                             f"({n_chunks} chunks)")
    if dev.type == "cuda":
        emit(profile_rank(lambda: fake_eval(dev, cache_dir=cache_dir)[1], "profile_rank_clip",
                          f"the clip evaluator on fake features, {n_chunks} chunks of "
                          f"{rank_chunk} against {n_windows} windows (gallery from the cache)"))

    # the first tenth of the videos: the card against the CPU path
    tenth = videos // 10
    want_small = fake_eval("cpu", gallery=tenth)[0]
    got_small, small_timings = fake_eval(dev, gallery=tenth)[:2]
    diff = tree_max_diff(got_small, want_small)
    emit({"phase": "clip_fake_vs_cpu", "gallery_videos": tenth,
          "metrics_max_abs_diff_vs_cpu": diff, "tol": EVAL_METRIC_TOL,
          "ap": got_small["ap"], "timings_s": small_timings})
    if not diff <= EVAL_METRIC_TOL:
        raise AssertionError(f"clip: card and CPU metrics differ by {diff} > {EVAL_METRIC_TOL}")

    # (b) the server builds, saves and serves the clip index of the first
    # ``real_videos`` videos from the synthetic store; then the evaluator
    # with the real extractor over the same videos
    store = SyntheticFrameStore()
    real_chunks = sum(-(-store.num_frames("validation", v.video_id) // frames)
                      for v in mdb.gallery[:real_videos])
    n_batches = -(-real_chunks // clips)
    index_dir = os.path.join(workdir, "clip_index")
    ready = threading.Event()
    holder = {}

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = ["--index_dir", index_dir, "--test_load", ckpt, "--port", "0", "--device", str(dev),
            "--dtype", "float32", "--regime", "clip", "--clip_sec", str(clip_sec),
            "--meta_split", spec_path, "--frame_store", "synthetic",
            "--max_gallery", str(real_videos), "--input_size", str(crop),
            "--test_frame", str(frames), "--test_batch_size", str(clips)]
    before = counts()
    t0 = time.perf_counter()
    srv_thread = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
    srv_thread.start()
    if not ready.wait(timeout=600):
        raise TimeoutError("server did not build its clip index")
    build_s = time.perf_counter() - t0
    server = holder["server"]
    try:
        feats = np.load(os.path.join(index_dir, "feats.npy"))
        with open(os.path.join(index_dir, "meta.json")) as f:
            meta = json.load(f)
        row_i = len(meta) // 3
        body, _ = post(f"http://127.0.0.1:{server.server_address[1]}/query/features",
                       json.dumps({"feature": feats[row_i].tolist(), "k": 10}).encode())
        top = body["results"][0]
        if (top["video_id"] != meta[row_i]["video_id"] or top["rank"] != 0
                or top.get("loc_sec") != meta[row_i]["loc_sec"]):
            raise AssertionError(f"feature query for clip row {row_i} answered {top}")
    finally:
        server.shutdown()
        srv_thread.join(timeout=60)
    build_launches = since(before)
    if feats.shape[1] != feat_dim or not np.isfinite(feats).all() or set(meta[0]) != {
            "video_id", "label", "loc_sec"}:
        raise AssertionError(f"clip index: shape {feats.shape}, meta {meta[:1]}")

    before = counts()
    feat_fn = make_feat_fn(load_reference_checkpoint(ckpt, device=dev), wire="yuv420",
                           dtype=torch.float32, device=dev)
    ex = FeatureExtractor(feat_fn, store, test_frames=frames, test_batch_size=clips,
                          input_size=crop, wire="yuv420", max_batches=n_batches,
                          cache_dir=os.path.join(workdir, "clip_real_cache"))
    ev = ARVRetrievalClip(mdb, spec, ex, clip_sec=clip_sec, rank_chunk=rank_chunk, device=dev)
    ev.gallery_videos = ev.gallery_videos[:real_videos]
    result = ev.evaluation()
    sync()
    real_launches = since(before)
    ev_feats = np.load(os.path.join(workdir, "clip_real_cache", "clip_gallery", "feats.npy"))
    feats_err = float(np.abs(ev_feats - feats).max()) if ev_feats.shape == feats.shape else None
    numbers = tree_numbers(result)
    kept = min(n_batches * clips, n_queries)
    eval_chunks = -(-kept // rank_chunk)
    launches = counts()
    # ---- end of the clip path ----
    emit({"phase": "clip_real", "gallery_videos": real_videos, "chunks": real_chunks,
          "embed_batches": n_batches, "clips_per_batch": clips, "frames": frames, "crop": crop,
          "clip_windows": feats.shape[0], "index_build_s": build_s,
          "tapes_clips_per_s": real_chunks / ev.timings["gallery_build"],
          "timings_s": ev.timings, "feats_max_abs_diff_vs_index": feats_err,
          "ap": result["ap"], "self_query_rank0": True, "loc_sec": top["loc_sec"],
          "launches_build_and_query": build_launches, "launches_evaluator": real_launches,
          "phase_s": time.perf_counter() - t_phase, "launches": launches})
    if feats_err is None or feats_err > 1e-5:
        raise AssertionError(f"evaluator clip features differ from the index's: {feats_err}")
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"clip_real metrics outside [0, 1]: {result}")
    if dev.type == "cuda" and (build_launches["stem_s2d_pool"] != n_batches
                               or build_launches["sq_l2"] < 1
                               or real_launches["stem_s2d_pool"] != 2 * n_batches
                               or real_launches["sq_l2"] != eval_chunks):
        raise AssertionError(f"clip_real launches: build {build_launches}, evaluator "
                             f"{real_launches}; {n_batches} batches, {eval_chunks} chunks")
    return {"launches": launches}


def full_sort_topk(scores, k: int):
    """The serving index's top-k (serve/index._masked_topk): one stable
    descending sort of the whole row, the lower column first on a tie."""
    import torch

    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, :k], top_i[:, :k]


def topk_then_pool_sort(scores, k: int):
    """``full_sort_topk``'s result without sorting the whole row, the
    alternative the moment phase times against it: ``torch.topk`` picks the
    pool, which is put in order by a stable sort on the column and then on
    the score. Which of several columns tied at the pool's lowest score
    ``torch.topk`` keeps is not specified; where it dropped one (a row holds
    more of that score than the pool does), the whole row is sorted."""
    import torch

    if k >= scores.shape[1]:
        return full_sort_topk(scores, k)
    top_s, top_i = torch.topk(scores, k, dim=1)
    floor = top_s[:, -1:]
    if torch.equal((scores == floor).sum(1), (top_s == floor).sum(1)):
        top_i, by_col = torch.sort(top_i, dim=1)
        top_s = top_s.gather(1, by_col)
        top_s, by_score = torch.sort(top_s, dim=1, descending=True, stable=True)
        return top_s, top_i.gather(1, by_score)
    return full_sort_topk(scores, k)


def worst_entry(a, b, path="result"):
    """(path, |a - b|) of the largest difference between two metric dicts
    of one structure (``tree_max_diff``'s maximum, located)."""
    if isinstance(a, dict):
        return max((worst_entry(a[k], b[k], f"{path}[{k!r}]") for k in a),
                   key=lambda t: t[1], default=(path, 0.0))
    if isinstance(a, (list, tuple)):
        return max((worst_entry(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))),
                   key=lambda t: t[1], default=(path, 0.0))
    if isinstance(a, (str, bool, type(None))):
        return path, 0.0
    return path, abs(float(a) - float(b))


def distinct_window(feats):
    """The row whose nearest other row is farthest (float64 on the host),
    and that distance: a query with its feature must bring it back first
    even through K1's 3xTF32 rounding (~1e-6 on unit rows)."""
    f = feats.astype(np.float64)
    sq = (f * f).sum(1)
    d = sq[:, None] + sq[None, :] - 2.0 * f @ f.T
    np.fill_diagonal(d, np.inf)
    nearest = d.min(1)
    row = int(nearest.argmax())
    return row, float(nearest[row])


def short_windows(vidx, s_sec, e_sec, n, longest=10.0):
    """``n`` rows spread over the gallery whose windows last at most
    ``longest`` seconds: a short window's pooled feature is far from every
    other window's, so its own query must bring it back at rank 0."""
    rows = np.flatnonzero(e_sec - s_sec <= longest)
    return [int(r) for r in rows[np.linspace(0, len(rows) - 1, n).astype(int)]]


def profile_moment_device(run, n_queries):
    """The device engine's rank loop over ``n_queries`` queries (one chunk)
    under torch.profiler: device ms by kernel, K1's, the spans of the
    engine's ranges (scoring, bucket sort, NMS with its pair matrices,
    within-block loop and cross-block pass, AP sort), kernel launches and
    runtime calls that synchronise, and the device's busy share of the
    loop's host time. ``run(profiled)`` returns
    the evaluator's timings; ``profiled`` wraps the rank loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = {}

    def profiled(rank_loop):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                # the tracer loses the first kernels after it starts (a
                # profiled rank loop alone lacked K1 and the first bucket's
                # sort): a few tiny kernels go first
                warm = torch.zeros(1, device="cuda")
                for _ in range(16):
                    warm.add_(1.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = rank_loop(*args, **kwargs)
                torch.cuda.synchronize()
                holder["wall_ms"] = (time.perf_counter() - t0) * 1e3
            holder["prof"] = prof
            return out
        return wrapped

    timings = run(profiled)
    prof, wall_ms = holder["prof"], holder["wall_ms"]
    kernels = device_ms_by_kernel(prof)
    calls = {e.key: e.count for e in prof.key_averages()
             if "Launch" in e.key or "Synchronize" in e.key or e.key.startswith("cudaMemcpy")}
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": "profile_moment_device", "queries": n_queries, "chunks": 1,
            "device_ms": device_ms if kernels else "not traced", "wall_ms": wall_ms,
            "device_busy_share": device_ms / wall_ms if kernels else "not traced",
            "sq_l2_ms": sum(v for k, v in kernels.items() if "sq_l2_kernel" in k),
            "sort_kernels_ms": sum(v for k, v in kernels.items() if "sort" in k.lower()),
            "ranges_ms": annotation_ms(prof),
            "runtime_calls": calls, "n_kernel_names": len(kernels),
            "timings_s": timings,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def moment_device_phase(dev, fake_eval, kept, host_got, host_timings, want_small, *,
                        query_cap, small_q, tenth, n_videos, counts):
    """``moment_device``: the device engine over the full-width gallery that
    ``moment_fake`` built (``kept``), against the host engine's metrics
    (``host_got``), its peak memory and ranking time beside the host
    engine's readback + postprocess; the same at a tenth of the videos
    against the CPU host engine (``want_small``); one chunk profiled."""
    import torch

    from vqwild_tpu_torch.retrieval.moment_device import _bucket_plan

    cuda = dev.type == "cuda"
    vidx = kept[1]
    plan = [[b["w"], len(b["vglob"])] for b in _bucket_plan(vidx, n_videos)]
    n_chunks = -(-query_cap // MOMENT_DEVICE_CHUNK)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    before = counts()
    got, timings, wall_s = fake_eval(dev, query_cap, engine="device", reuse=kept)
    if cuda:
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    diff = tree_max_diff(got, host_got)
    ranking_s = sum(timings[k] for k in ("engine_build", "gallery_to_device", "metrics_device",
                                         "metrics_readback"))
    host_ranking_s = host_timings["score_readback"] + host_timings["postprocess"]
    small, small_timings = fake_eval(dev, small_q, gallery=tenth, engine="device")[:2]
    diff_small = tree_max_diff(small, want_small)
    emit({"phase": "moment_device", "moment_windows": int(len(vidx)), "queries": query_cap,
          "chunks": n_chunks, "chunk": MOMENT_DEVICE_CHUNK, "scan_chunks": MOMENT_SCAN_CHUNKS,
          "buckets_width_videos": plan,
          "padded_slots_per_query": sum(w * v for w, v in plan),
          "nms_steps_per_chunk": sum(w for w, _ in plan),
          "resolved_engine": "device", "timings_s": timings, "wall_s": wall_s,
          "ranking_s": ranking_s, "ms_per_chunk": 1e3 * (timings["metrics_device"]
                                                         + timings["metrics_readback"]) / n_chunks,
          "host_engine_score_readback_plus_postprocess_s": host_ranking_s,
          "peak_device_memory_gb": peak_gb,
          "metrics_max_abs_diff_vs_host_engine": diff, "tol": EVAL_METRIC_TOL,
          "largest_diff_at": worst_entry(got, host_got)[0],
          "tenth_videos": tenth, "tenth_queries": small_q,
          "tenth_max_abs_diff_vs_cpu_host_engine": diff_small,
          "tenth_largest_diff_at": worst_entry(small, want_small)[0],
          "tenth_timings_s": small_timings,
          "ap": got["map05"]["ap"], "host_engine_ap": host_got["map05"]["ap"],
          "launches": launches})
    numbers = tree_numbers(got)
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"moment_device metrics outside [0, 1]: {got}")
    if set(timings) != {"query_feats", "engine_build", "gallery_to_device", "metrics_device",
                        "metrics_readback"}:
        raise AssertionError(f"moment_device timings: {sorted(timings)}")
    if not diff <= EVAL_METRIC_TOL:
        raise AssertionError(f"moment_device: device and host engines differ by {diff}")
    if not diff_small <= EVAL_METRIC_TOL:
        raise AssertionError(f"moment_device: the card at a tenth differs from the CPU host "
                             f"engine by {diff_small}")
    if cuda and launches != {"sq_l2": n_chunks, "stem_s2d_pool": 0}:
        raise AssertionError(f"moment_device: launches {launches}, expected K1 once per chunk "
                             f"({n_chunks} chunks of {MOMENT_DEVICE_CHUNK})")
    if cuda:
        emit(profile_moment_device(
            lambda profiled: fake_eval(dev, MOMENT_DEVICE_CHUNK, engine="device", reuse=kept,
                                       profiled=profiled)[1],
            MOMENT_DEVICE_CHUNK))


def phase_moment(dev, workdir, ckpt, *, videos, queries, labels, query_cap, real_videos, clips,
                 frames, crop, moment_clip_sec, max_clips, feat_dim=512, rank_chunk=128,
                 serve_queries=32, serve_conc=8, serve_k=10, pool=4096):
    import torch

    from vqwild_tpu_torch.data.frames import SyntheticFrameStore
    from vqwild_tpu_torch.data.labels import get_split
    from vqwild_tpu_torch.data.schema import load_moment_db
    from vqwild_tpu_torch.models.convert import load_reference_checkpoint
    from vqwild_tpu_torch.ops import distance, stem_pool
    from vqwild_tpu_torch.retrieval import (
        ARVRetrievalMoment, FeatureExtractor, make_fake_feat_fn, make_feat_fn,
    )
    from vqwild_tpu_torch.serve.__main__ import main as serve_main
    from vqwild_tpu_torch.serve.http import make_server
    from vqwild_tpu_torch.serve.index import MomentIndex
    from vqwild_tpu_torch.serve.service import QueryService

    def counts():
        return {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}

    def since(before):
        return {k: v - before[k] for k, v in counts().items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    spec_path, video_frames = write_moment_db(workdir, videos=videos, queries=queries,
                                              labels=labels, seed=8)
    distance.launches.reset()
    stem_pool.launches.reset()
    # ---- the moment path, from here to the counter read at the end ----
    spec = get_split(spec_path)
    mdb = load_moment_db(spec.moment_db_json)
    n_all_queries = len(mdb.nonnoise_queries())

    # (a) seeded fake features over the whole gallery, the queries cut to
    # ``query_cap``; the built gallery is kept for the device engine and the
    # serving part, which reuse it (``reuse``) instead of building it again
    def fake_eval(device, n_queries, gallery=None, keep=None, engine="host", reuse=None,
                  profiled=None):
        ex = FeatureExtractor(make_fake_feat_fn(feat_dim, seed=10), length_store(video_frames),
                              test_frames=frames, test_batch_size=clips, fake=True)
        ev = ARVRetrievalMoment(mdb, spec, ex, moment_clip_sec=moment_clip_sec,
                                max_clips_per_moment=max_clips, rank_chunk=rank_chunk,
                                device=device, engine=engine)
        ev.queries = ev.queries[:n_queries]
        if gallery is not None:
            ev.gallery_videos = ev.gallery_videos[:gallery]
        if keep is not None:
            build = ev.build_gallery

            def build_and_keep():
                keep["gallery"] = build()
                return keep["gallery"]

            ev.build_gallery = build_and_keep
        if reuse is not None:
            ev.build_gallery = lambda: reuse
        if profiled is not None:  # the device engine's rank loop alone
            ev._device_scan_rank = profiled(ev._device_scan_rank)
        t0 = time.perf_counter()
        result = ev.evaluation()
        want = "native" if engine == "host" else engine
        if ev.resolved_engine != want:
            raise AssertionError(f"moment postprocess ran on {ev.resolved_engine!r}, not the "
                                 f"{want} engine")
        return result, ev.timings, time.perf_counter() - t0

    keep = {}
    before = counts()
    got, timings, wall_s = fake_eval(dev, query_cap, keep=keep)
    sync()
    fake_launches = since(before)
    feats, vidx, s_sec, e_sec, _, _ = keep["gallery"]
    n_windows = feats.shape[0]
    n_chunks = -(-query_cap // rank_chunk)
    numbers = tree_numbers(got)
    emit({"phase": "moment_fake", "gallery_videos": videos, "moment_windows": n_windows,
          "max_windows_per_video": int(np.bincount(vidx).max()),
          "moment_clip_sec": moment_clip_sec, "max_clips_per_moment": max_clips,
          "queries": query_cap, "chunks": n_chunks, "rank_chunk": rank_chunk,
          "feat_dim": feat_dim, "reduced": {"queries": [query_cap, n_all_queries]},
          "gallery_gb": feats.nbytes / 1e9,
          "score_readback_gb": query_cap * n_windows * 4 / 1e9,
          "ap": got["map05"]["ap"], "o1_class_agnostic_map": got["map05"]["o1_class_agnostic_map"],
          "timings_s": timings, "postprocess_ms_per_query": 1e3 * timings["postprocess"] / query_cap,
          "score_readback_gb_per_s": query_cap * n_windows * 4 / 1e9 / timings["score_readback"],
          "wall_s": wall_s, "resolved_engine": "native", "launches": fake_launches})
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"moment_fake metrics outside [0, 1]: {got}")
    if set(timings) != {"query_feats", "tape_build", "window_pool", "gallery_to_device",
                        "score_device", "score_readback", "postprocess"}:
        raise AssertionError(f"moment_fake timings: {sorted(timings)}")
    if dev.type == "cuda" and fake_launches != {"sq_l2": n_chunks, "stem_s2d_pool": 0}:
        raise AssertionError(f"moment_fake: launches {fake_launches}, expected K1 once per "
                             f"chunk ({n_chunks} chunks)")

    # the first tenth of the videos: the card against the CPU path
    tenth, small_q = videos // 10, 2 * rank_chunk
    want_small = fake_eval("cpu", small_q, gallery=tenth)[0]
    got_small, small_timings = fake_eval(dev, small_q, gallery=tenth)[:2]
    diff = tree_max_diff(got_small, want_small)
    emit({"phase": "moment_fake_vs_cpu", "gallery_videos": tenth, "queries": small_q,
          "metrics_max_abs_diff_vs_cpu": diff, "tol": EVAL_METRIC_TOL,
          "largest_diff_at": worst_entry(got_small, want_small)[0],
          "ap": got_small["map05"]["ap"], "timings_s": small_timings})
    if not diff <= EVAL_METRIC_TOL:
        raise AssertionError(f"moment: card and CPU metrics differ by {diff} > {EVAL_METRIC_TOL}")

    # (b) the device engine (NMS and grouped-order AP as torch ops, K1 once
    # per chunk of 32) on the same queries over the kept gallery
    moment_device_phase(dev, fake_eval, keep["gallery"], got, timings, want_small,
                        query_cap=query_cap, small_q=small_q, tenth=tenth,
                        n_videos=len(mdb.gallery), counts=counts)

    # (c) /query/moments over the fake gallery's MomentIndex, sequential and
    # ``serve_conc``-way concurrent; then the pool's top-k two ways
    t0 = time.perf_counter()
    index = MomentIndex(feats, [v.video_id for v in mdb.gallery], vidx, s_sec, e_sec, device=dev)
    sync()
    index_s = time.perf_counter() - t0
    del keep, feats
    service = QueryService(index, moment_index=index, max_wait_ms=5.0)
    server = make_server(service, port=0)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    g = index.scorer.g_dev
    rows = short_windows(vidx, s_sec, e_sec, serve_queries)
    url = f"http://127.0.0.1:{server.server_address[1]}/query/moments"

    def moment_req(r):
        body, ms = post(url, json.dumps({"feature": g[r].tolist(), "k": serve_k}).encode())
        top = body["results"][0]
        if (top["video_id"] != mdb.gallery[int(vidx[r])].video_id or top["rank"] != 0
                or top["start_sec"] != s_sec[r] or top["end_sec"] != e_sec[r]
                or len(body["results"]) != serve_k):
            raise AssertionError(f"moment query for window {r} answered {top}")
        return ms

    try:
        concurrently([(lambda r=r: moment_req(r)) for r in rows[:serve_conc]])  # warm-up
        seq = [moment_req(r) for r in rows]
        conc = []
        for i in range(0, len(rows), serve_conc):
            conc += concurrently([(lambda r=r: moment_req(r)) for r in rows[i:i + serve_conc]])
    finally:
        server.shutdown()
        srv_thread.join(timeout=60)
        server.server_close()
        service.close()
    topk_ms = {}
    for b in (1, 16):
        scores = index.scorer.scores(g[rows[:b]].contiguous())
        got_k, want_k = topk_then_pool_sort(scores, pool), full_sort_topk(scores, pool)
        if not (torch.equal(got_k[0], want_k[0]) and torch.equal(got_k[1], want_k[1])):
            raise AssertionError(f"topk_then_pool_sort differs from the full sort at B = {b}")
        if dev.type == "cuda":
            topk_ms[f"b{b}"] = {
                "full_stable_sort_ms": time_ms(lambda: full_sort_topk(scores, pool)),
                "topk_then_pool_sort_ms": time_ms(lambda: topk_then_pool_sort(scores, pool))}
    # the evaluation's two host costs measured apart on one chunk's [128, G]
    # scores: the readback into pageable (the evaluator's) or pinned memory,
    # and the native postprocess on 1 thread or the evaluator's 8
    host_costs = {}
    if dev.type == "cuda":
        from vqwild_tpu_torch.native import lib as native_lib
        from vqwild_tpu_torch.ops.hostmem import alloc_array

        block = index.scorer.scores(g[:rank_chunk].contiguous())
        for kind, buf in (("pageable", torch.from_numpy(alloc_array(tuple(block.shape)))),
                          ("pinned", torch.empty(block.shape, pin_memory=True))):
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                buf.copy_(block)
                secs.append(time.perf_counter() - t0)
            host_costs[f"readback_{kind}_gb_per_s"] = block.numel() * 4 / 1e9 / float(np.median(secs))
        del block
        nq = 16
        cols = dict(video_idx=vidx.astype(np.int32), start_sec=s_sec.astype(np.float32),
                    end_sec=e_sec.astype(np.float32), hit_label=np.full(len(vidx), -1, np.int32),
                    hit_iou=np.zeros(len(vidx), np.float32), q_label=np.zeros(nq, np.int32),
                    ignore_vids=np.full((nq, 1), -1, np.int32))
        for threads in (1, 8):
            t0 = time.perf_counter()
            native_lib.moment_batch(buf[:nq].numpy(), **cols, nms_thresh=0.5, tiou_thresh=0.5,
                                    r_at_n=(30, 50, 100), robust=True, n_threads=threads)
            host_costs[f"postprocess_ms_per_query_{threads}_threads"] = (
                1e3 * (time.perf_counter() - t0) / nq)
        host_costs["host_cpus"] = os.cpu_count()
        del buf
    emit({"phase": "moment_serve", "index_rows": index.n, "index_build_s": index_s, "k": serve_k,
          "candidate_pool": pool, "queries": len(rows), "moment_host_costs": host_costs,
          "moment_query_p50_ms_sequential": float(np.median(seq)),
          f"moment_query_p50_ms_concurrent_{serve_conc}": float(np.median(conc)),
          "masked_topk_at_moment_width": topk_ms, "self_window_rank0": True})
    del index, service, g
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (d) the server builds, saves and serves the moment index of the first
    # ``real_videos`` videos from the synthetic store through the trunk; a
    # second server loads it; then the evaluator with the real extractor
    store = SyntheticFrameStore()
    real_chunks = sum(-(-store.num_frames("validation", v.video_id) // frames)
                      for v in mdb.gallery[:real_videos])
    n_batches = -(-real_chunks // clips)
    index_dir = os.path.join(workdir, "moment_index")

    def start_server(argv):
        ready = threading.Event()
        holder = {}

        def on_ready(server):
            holder["server"] = server
            ready.set()

        thread = threading.Thread(target=serve_main, args=(argv, on_ready), daemon=True)
        thread.start()
        if not ready.wait(timeout=600):
            raise TimeoutError("moment server did not start")
        return holder["server"], thread

    def ask(server, feature):
        body, _ = post(f"http://127.0.0.1:{server.server_address[1]}/query/moments",
                       json.dumps({"feature": feature, "k": serve_k}).encode())
        return body["results"]

    argv = ["--index_dir", index_dir, "--port", "0", "--device", str(dev),
            "--dtype", "float32", "--regime", "moment", "--moment_clip_sec", str(moment_clip_sec),
            "--max_clips_per_moment", str(max_clips), "--meta_split", spec_path,
            "--frame_store", "synthetic", "--max_gallery", str(real_videos),
            "--input_size", str(crop), "--test_frame", str(frames),
            "--test_batch_size", str(clips)]
    before = counts()
    t0 = time.perf_counter()
    server, thread = start_server(argv + ["--test_load", ckpt])
    build_s = time.perf_counter() - t0
    try:
        real_feats = np.load(os.path.join(index_dir, "feats.npy"))
        with np.load(os.path.join(index_dir, "windows.npz")) as z:
            r_vidx, r_start, r_end = z["video_idx"], z["start_sec"], z["end_sec"]
        row, margin = distinct_window(real_feats)
        built = ask(server, real_feats[row].tolist())
    finally:
        server.shutdown()
        thread.join(timeout=60)
    top = built[0]
    if (top["video_id"] != mdb.gallery[int(r_vidx[row])].video_id or top["rank"] != 0
            or top["start_sec"] != r_start[row] or top["end_sec"] != r_end[row]):
        raise AssertionError(f"moment query for built window {row} answered {top}")
    build_launches = since(before)
    server, thread = start_server(["--index_dir", index_dir, "--port", "0", "--device", str(dev),
                                   "--no_embed"])
    try:
        loaded = ask(server, real_feats[row].tolist())
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if loaded != built:
        raise AssertionError(f"the loaded moment index answered {loaded[:1]}, the built one "
                             f"{built[:1]}")

    before = counts()
    feat_fn = make_feat_fn(load_reference_checkpoint(ckpt, device=dev), wire="yuv420",
                           dtype=torch.float32, device=dev)
    ex = FeatureExtractor(feat_fn, store, test_frames=frames, test_batch_size=clips,
                          input_size=crop, wire="yuv420", max_batches=n_batches,
                          cache_dir=os.path.join(workdir, "moment_real_cache"))
    ev = ARVRetrievalMoment(mdb, spec, ex, moment_clip_sec=moment_clip_sec,
                            max_clips_per_moment=max_clips, rank_chunk=rank_chunk, device=dev)
    ev.gallery_videos = ev.gallery_videos[:real_videos]
    result = ev.evaluation()
    sync()
    real_launches = since(before)
    ev_feats = np.load(os.path.join(workdir, "moment_real_cache", "moment_gallery", "feats.npy"))
    feats_err = (float(np.abs(ev_feats - real_feats).max())
                 if ev_feats.shape == real_feats.shape else None)
    numbers = tree_numbers(result)
    kept = min(n_batches * clips, n_all_queries)
    # on the card ``auto`` takes the device engine: its chunks of 32 are
    # padded to whole super-chunks, each scored by K1
    device_chunks = -(-kept // MOMENT_DEVICE_CHUNK)
    scan = min(MOMENT_SCAN_CHUNKS, device_chunks)
    eval_chunks = -(-device_chunks // scan) * scan
    want_engine = "device" if dev.type == "cuda" else "native"
    launches = counts()
    # ---- end of the moment path ----
    emit({"phase": "moment_real", "gallery_videos": real_videos, "chunks": real_chunks,
          "embed_batches": n_batches, "clips_per_batch": clips, "frames": frames, "crop": crop,
          "moment_windows": real_feats.shape[0], "index_build_s": build_s,
          "timings_s": ev.timings, "resolved_engine": ev.resolved_engine,
          "feats_max_abs_diff_vs_index": feats_err, "ap": result["map05"]["ap"],
          "self_window_rank0": True, "loaded_index_same_answer": True,
          "window": [top["video_id"], top["start_sec"], top["end_sec"]],
          "window_row": row, "window_nearest_sq_dist": margin,
          "launches_build_and_query": build_launches, "launches_evaluator": real_launches,
          "phase_s": time.perf_counter() - t_phase, "launches": launches})
    if feats_err is None or feats_err > 1e-5:
        raise AssertionError(f"evaluator moment features differ from the index's: {feats_err}")
    if not numbers or not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in numbers):
        raise AssertionError(f"moment_real metrics outside [0, 1]: {result}")
    if ev.resolved_engine != want_engine:
        raise AssertionError(f"moment_real: engine {ev.resolved_engine!r}, not {want_engine!r}")
    if dev.type == "cuda" and (build_launches["stem_s2d_pool"] != n_batches
                               or build_launches["sq_l2"] < 1
                               or real_launches["stem_s2d_pool"] != 2 * n_batches
                               or real_launches["sq_l2"] != eval_chunks):
        raise AssertionError(f"moment_real launches: build {build_launches}, evaluator "
                             f"{real_launches}; {n_batches} batches, {eval_chunks} chunks")
    return {"launches": launches, "windows": n_windows}


def train_batches(n, *, triplets, frames, crop, nclass, seed):
    """``n`` seeded batches of ``triplets`` (anchor, positive, negative)
    clips, uint8 [3·triplets, frames, crop, crop, 3], and their labels: an
    anchor and its positive share a label, drawn from a quarter of the
    classes, so labels repeat within a batch and the EMA memory compounds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        clips = rng.integers(0, 256, (3 * triplets, frames, crop, crop, 3), dtype=np.uint8)
        pos = rng.integers(0, nclass // 4, triplets)
        neg = (pos + 1 + rng.integers(0, nclass - 1, triplets)) % nclass
        out.append((clips, np.stack([pos, pos, neg], axis=1).reshape(-1).astype(np.int64)))
    return out


def train_run(dev, method, dtype, wire, data, sem, *, warmup, timed):
    """``warmup`` then ``timed`` train steps of a seeded full-width model on
    batches already on the card (the loader's upload is not in the step):
    ms a step (host clock to a synchronize after each step), clips/s,
    frames/s, peak device memory and every timed step's losses."""
    import torch

    from vqwild_tpu_torch.core.config import ModelConfig
    from vqwild_tpu_torch.models.arv import build_model
    from vqwild_tpu_torch.ops.preprocess import rgb_to_yuv420_host
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    cuda = dev.type == "cuda"  # a rehearsal on the CPU times nothing of the card
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = ModelConfig(method=method, nclass=TRAIN_NCLASS, semantic_dim=TRAIN_SEM_DIM,
                      compute_dtype=dtype)
    model = build_model(cfg, device=dev, seed=0)
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
    state = create_train_state(model, tx, seed=1)
    step = make_train_step(model, tx, semantic_memory=sem if method == "vasa" else None,
                           wire=wire)
    on_card = [(tuple(torch.from_numpy(a).to(dev) for a in
                      (rgb_to_yuv420_host(c) if wire == "yuv420" else (c,))),
                torch.from_numpy(y).to(dev)) for c, y in data]
    ms, losses = [], []
    for i in range(warmup + timed):
        arrays, labels = on_card[i % len(on_card)]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ls = step(state, *arrays, labels)
        if cuda:
            torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(ls)
    losses = [{k: float(v) for k, v in ls.items()} for ls in losses]
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError(f"train {method} {dtype} {wire}: a loss is not finite: {losses}")
    n_clips = int(on_card[0][1].shape[0])
    n_frames = n_clips * int(on_card[0][0][0].shape[1])
    med = float(np.median(ms))
    row = {"phase": "train", "method": method, "dtype": dtype, "wire": wire,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "clips": n_clips, "frames": n_frames, "warmup_steps": warmup,
           "timed_steps": timed, "ms_per_step_median": med, "ms_per_step_min": min(ms),
           "ms_per_step_max": max(ms), "clips_per_s": n_clips / med * 1e3,
           "frames_per_s": n_frames / med * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
           "params": sum(p.numel() for p in model.parameters()), "losses": losses}
    emit(row)
    return row


def phase_train(dev, *, triplets, frames, crop, warmup, timed):
    """The train step at full width for baseline, va and vasa: fp32 (TF32
    off) and bf16 over the same seeded batches, then one fp32 step on the
    yuv420 wire. The launch counters are zeroed just before and read just
    after: training runs neither K1 nor K2."""
    import torch

    from vqwild_tpu_torch.ops import distance, stem_pool

    data = train_batches(2, triplets=triplets, frames=frames, crop=crop, nclass=TRAIN_NCLASS,
                         seed=11)
    sem = np.random.default_rng(12).standard_normal((TRAIN_NCLASS, TRAIN_SEM_DIM))
    sem = (sem / np.linalg.norm(sem, axis=1, keepdims=True)).astype(np.float32)
    distance.launches.reset()
    stem_pool.launches.reset()
    rows = []
    for method in ("baseline", "va", "vasa"):
        for dtype in ("float32", "bfloat16"):
            rows.append(train_run(dev, method, dtype, "rgb", data, sem, warmup=warmup,
                                  timed=timed))
        rows.append(train_run(dev, method, "float32", "yuv420", data[:1], sem, warmup=0,
                              timed=1))
    launches = {"sq_l2": distance.launches.n, "stem_s2d_pool": stem_pool.launches.n}
    if any(launches.values()):
        raise AssertionError(f"the train step launched a retrieval kernel: {launches}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def train_vs_cpu(dev, *, steps, batch, frames, crop):
    """The same seeded weights and batches (``batch`` clips of ``frames`` x
    ``crop``², va, Adam, dropout off: the CPU's and the card's generators
    draw different masks) for ``steps`` steps on the card and on the CPU.
    Each card step starts from the CPU run's parameters, BN statistics and
    memory after the step before (the optimizer's moments are the card's
    own): two fp32 programs that start a step from one state agree to
    rounding, and free-running they drift through ReLUs near their kink.
    After each step the largest differences of the losses, parameters, BN
    statistics and memory, and the share of the parameter elements with a
    resolved gradient (|g| > 1e-3 of the tensor's largest on the card) that
    differ by more than 1e-5, over all parameters and over the non-local
    block's alone, are held to TRAIN_VS_CPU_TOL; every parameter to an Adam
    step's 2·lr (a small gradient's sign may differ). The two biases whose
    gradient is 0 in exact arithmetic (ZERO_GRADS) are held to 2·lr only."""
    import torch

    from vqwild_tpu_torch.models.arv import ARVModel, init_model
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    rng = np.random.default_rng(13)
    data = [(rng.integers(0, 256, (batch, frames, crop, crop, 3), dtype=np.uint8),
             rng.integers(0, 20, batch // 2).repeat(2)) for _ in range(steps)]
    lr = 1e-4
    runs = {}
    for d in (torch.device("cpu"), dev):
        model = init_model(ARVModel("va", nclass=20, dropout=0.0, nl_dropout=0.0), seed=3).to(d)
        tx = make_optimizer(init_lr=lr, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
        state = create_train_state(model, tx, seed=1)
        grads = []
        state.optimizer.register_step_pre_hook(lambda opt, args, kwargs: grads.append(
            {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}))
        step = make_train_step(model, tx)
        states, losses = [], []
        for i, (clips, labels) in enumerate(data):
            if d.type == "cuda" and i > 0:
                model.load_state_dict(runs["cpu"]["states"][i - 1])
            state, ls = step(state, clips, labels)
            losses.append({k: float(v) for k, v in ls.items()})
            states.append({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        runs[d.type] = {"states": states, "losses": losses, "grads": grads}
    tol = TRAIN_VS_CPU_TOL
    out = {"phase": "train_vs_cpu", "method": "va", "steps": steps,
           "shape": [batch, frames, crop, crop, 3], "tolerance": tol, "per_step": []}
    for i in range(steps):
        a, b, g = runs["cuda"]["states"][i], runs["cpu"]["states"][i], runs["cuda"]["grads"][i]
        diff = {k: (a[k].float() - b[k].float()).abs() for k in b}
        counts = {"all": [0, 0], "non_local": [0, 0]}
        for name, gr in g.items():
            if name in ZERO_GRADS:
                continue
            mask = gr.abs() > 1e-3 * gr.abs().max()
            if not mask.any():  # a gradient 0 everywhere: only weight decay moved it
                mask[...] = True
            off = int((diff[name][mask] > 1e-5).sum())
            for key in ("all", "non_local") if name.startswith("cls_nl.") else ("all",):
                counts[key][0] += off
                counts[key][1] += int(mask.sum())
        row = {
            "loss": max(abs(runs["cuda"]["losses"][i][k] - runs["cpu"]["losses"][i][k])
                        for k in runs["cpu"]["losses"][i]),
            "param_max": max(float(diff[n].max()) for n in g),
            "resolved_share_over_1e-5": counts["all"][0] / counts["all"][1],
            "non_local_resolved_share_over_1e-5": counts["non_local"][0] / counts["non_local"][1],
            "all_share_over_1e-5": sum(int((diff[n] > 1e-5).sum()) for n in g) / sum(
                diff[n].numel() for n in g),
            "bn_mean": max(float(v.max()) for k, v in diff.items() if k.endswith("running_mean")),
            "bn_var_rel": max(float((v / b[k].abs().clamp_min(1e-6)).max())
                              for k, v in diff.items() if k.endswith("running_var")),
            "memory": float(diff["visual_memory"].max())}
        out["per_step"].append(row)
        bad = [k for k in tol if not row[k] <= tol[k]]
        if bad or not row["param_max"] <= 2 * lr:
            raise AssertionError(f"train_vs_cpu step {i}: {row} against {tol}")
    emit(out)
    return out


def stem_s2d(x, weight):
    """The 7x7/2 stem as the JAX trunk's ``stem_s2d`` computes it, a 4x4/1
    conv over 2x2 space-to-depth input (even H and W): the [64,12,4,4]
    kernel is a re-index of the [64,3,1,7,7] weight, ks[o, (r*2+s)*3+c, a, b]
    = k[o, c, 2(a-2)+r+3, 2(b-2)+s+3], zero outside the 7x7. The port's trunk
    runs the 7x7 conv; ``train_choices`` times this against it."""
    import torch.nn.functional as F

    n, c, h, w = x.shape
    o = weight.shape[0]
    # one zero row/column in front puts tap 2(a-2)+r+3 at 2a+r of 8
    kp = F.pad(weight[:, :, 0].to(x.dtype), (1, 0, 1, 0))  # [O, C, 8, 8]
    ks = kp.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)
    xs = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return F.conv2d(F.pad(xs.reshape(n, 4 * c, h // 2, w // 2), (2, 1, 2, 1)), ks)


def train_choices(dev, *, frames, crop):
    """The train step's two choices between formulations of one function,
    each timed forward and backward (CUDA events) against the other at the
    full-width stem's shapes, fp32 (TF32 off) and bf16: the stem, the trunk's 7x7/2 conv against ``stem_s2d``
    ([frames, 3, crop, crop], the weight's gradient); the stem BN in train
    mode ([frames, 64, crop/2, crop/2], the gradients of the input, weight
    and bias), ``F.batch_norm`` against ``TorchBatchNorm.split_statistics``.
    Also the largest difference of each pair's outputs."""
    import torch
    import torch.nn.functional as F

    from vqwild_tpu_torch.models.heads import TorchBatchNorm
    from vqwild_tpu_torch.models.resnet_f2f import Conv2dF2F

    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"phase": "train_choices", "stem_shape": [frames, 3, crop, crop],
           "bn_shape": [frames, 64, crop // 2, crop // 2]}
    for dt in (torch.float32, torch.bfloat16):
        row = {}
        x = torch.randn(frames, 3, crop, crop, generator=gen, device=dev).to(dt)
        cot = torch.randn(frames, 64, crop // 2, crop // 2, generator=gen, device=dev).to(dt)
        conv = Conv2dF2F(3, 64, 7, 2, 3).to(dev)
        stems = {"stem_7x7_ms": conv, "stem_s2d_ms": lambda x: stem_s2d(x, conv.weight)}
        with torch.no_grad():
            row["stem_max_abs_diff"] = float((conv(x).float() - stem_s2d(x, conv.weight).float())
                                             .abs().max())
        for name, fn in stems.items():
            row[name] = time_ms(lambda fn=fn: torch.autograd.grad(fn(x), conv.weight, cot),
                                iters=10)
        del x
        h = cot.requires_grad_()
        forms = {
            "bn_fused_ms": (TorchBatchNorm(64, 1e-3, 0.01).to(dev), lambda bn: F.batch_norm(
                h, bn.running_mean, bn.running_var, bn.weight, bn.bias, True, bn.momentum,
                bn.eps)),
            "bn_split_ms": (TorchBatchNorm(64, 1e-3, 0.01).to(dev),
                            lambda bn: bn.split_statistics(h))}
        with torch.no_grad():
            fused, split = (fn(bn).float() for bn, fn in forms.values())
            row["bn_max_abs_diff"] = float((fused - split).abs().max())
            del fused, split
        for name, (bn, fn) in forms.items():
            row[name] = time_ms(lambda bn=bn, fn=fn: torch.autograd.grad(
                fn(bn), (h, bn.weight, bn.bias), cot), iters=10)
        out[str(dt).split(".")[-1]] = row
        del h, cot
    torch.cuda.empty_cache()
    emit(out)
    return out


def profile_train(dev, *, triplets, frames, crop):
    """One fp32 va step at full width under torch.profiler (after two
    unprofiled steps): the ten device operations that take the most time,
    and the share of the device time in cuDNN convolutions forward
    (aten::cudnn_convolution) and backward (aten::convolution_backward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vqwild_tpu_torch.core.config import ModelConfig
    from vqwild_tpu_torch.models.arv import build_model
    from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    (clips, labels), = train_batches(1, triplets=triplets, frames=frames, crop=crop,
                                     nclass=TRAIN_NCLASS, seed=14)
    model = build_model(ModelConfig(method="va", nclass=TRAIN_NCLASS), device=dev, seed=0)
    tx = make_optimizer(init_lr=1e-4, weight_decay=1e-5, steps_per_epoch=100, lr_decay_epoch=9)
    state = create_train_state(model, tx, seed=1)
    step = make_train_step(model, tx)
    clips, labels = torch.from_numpy(clips).to(dev), torch.from_numpy(labels).to(dev)
    for _ in range(2):
        state, _ = step(state, clips, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the tracer loses the first kernels after it starts: tiny ones go first
        warm = torch.zeros(1, device=dev)
        for _ in range(16):
            warm.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, clips, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_ms_by_kernel(prof)
    device_ms = sum(kernels.values())
    ops = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
           if e.key in ("aten::cudnn_convolution", "aten::convolution_backward")}
    conv_fwd, conv_bwd = ops.get("aten::cudnn_convolution", 0.0), ops.get(
        "aten::convolution_backward", 0.0)
    calls = {e.key: e.count for e in prof.key_averages() if "Launch" in e.key}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    out = {"phase": "profile_train", "what": "one fp32 va step, 30 clips x 32 x 112x112",
           "wall_ms": wall_ms, "device_ms": device_ms if kernels else "not traced",
           "device_busy_share": device_ms / wall_ms if kernels else "not traced",
           "conv_fwd_ms": conv_fwd, "conv_bwd_ms": conv_bwd,
           "conv_fwd_share": conv_fwd / device_ms if kernels else "not traced",
           "conv_bwd_share": conv_bwd / device_ms if kernels else "not traced",
           "runtime_calls": calls, "n_kernel_names": len(kernels),
           "top_kernels_ms": [[k[:90], v] for k, v in top]}
    emit(out)
    return out


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
    train = phase_train(dev, triplets=TRAIN_TRIPLETS, frames=FRAMES, crop=CROP,
                        warmup=TRAIN_WARMUP, timed=TRAIN_TIMED)
    train_choices(dev, frames=TRAIN_TRIPLETS * 3 * FRAMES, crop=CROP)
    train_vs_cpu(dev, steps=3, batch=6, frames=2, crop=32)
    profile_train(dev, triplets=TRAIN_TRIPLETS, frames=FRAMES, crop=CROP)
    with tempfile.TemporaryDirectory() as workdir:
        serve = phase_serve(dev, workdir, batches=EMBED_BATCHES, clips=CLIPS, frames=FRAMES,
                            crop=CROP, gallery_rows=GALLERY_ROWS, ref_clips=2, ref_frames=4,
                            n_feature_q=32, n_clip_q=8)
        evald = phase_eval(dev, workdir, os.path.join(workdir, "best.pth.tar"),
                           labels=EVAL_LABELS, per_label=EVAL_PER_LABEL,
                           queries_per_label=EVAL_QUERIES_PER_LABEL,
                           distractors=EVAL_DISTRACTORS, real_records=EVAL_REAL_RECORDS,
                           clips=CLIPS, frames=FRAMES, crop=CROP)
        clip = phase_clip(dev, workdir, os.path.join(workdir, "best.pth.tar"),
                          videos=CLIP_VIDEOS, queries=CLIP_QUERIES, labels=CLIP_LABELS,
                          real_videos=CLIP_REAL_VIDEOS, clips=CLIPS, frames=FRAMES, crop=CROP,
                          clip_sec=CLIP_SEC)
        moment = phase_moment(dev, workdir, os.path.join(workdir, "best.pth.tar"),
                              videos=CLIP_VIDEOS, queries=CLIP_QUERIES, labels=CLIP_LABELS,
                              query_cap=MOMENT_QUERY_CAP, real_videos=MOMENT_REAL_VIDEOS,
                              clips=CLIPS, frames=FRAMES, crop=CROP,
                              moment_clip_sec=MOMENT_CLIP_SEC, max_clips=MOMENT_MAX_CLIPS)
    if moment["windows"] != K1_MOMENT_CHUNK[1] or K1_MOMENT_DEVICE_CHUNK[1] != K1_MOMENT_CHUNK[1]:
        raise AssertionError(f"the moment gallery has {moment['windows']} windows; K1 was timed "
                             f"at {K1_MOMENT_CHUNK} and {K1_MOMENT_DEVICE_CHUNK}")

    k1_main = k1[0]  # (16, 7670, 512): the smoke's gallery at a full query bucket
    k1_eval = next(r for r in k1 if tuple(r["shape"]) == K1_EVAL_CHUNK)
    k1_clip = next(r for r in k1 if tuple(r["shape"]) == K1_CLIP_CHUNK)
    k1_moment = next(r for r in k1 if tuple(r["shape"]) == K1_MOMENT_CHUNK)
    k1_moment_device = next(r for r in k1 if tuple(r["shape"]) == K1_MOMENT_DEVICE_CHUNK)
    k2_main = k2[0]  # an embed batch in fp32, the serving dtype
    paths = {"serve": serve["launches"], "eval": evald["launches"], "clip": clip["launches"],
             "moment": moment["launches"], "train": train["launches"]}
    launches = {k: sum(p[k] for p in paths.values()) for k in serve["launches"]}
    chunk_keys = ("shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "sq_l2", "route": "cuda", "source": "vqwild_tpu_torch/csrc/sq_l2.cu",
         "replaces": "vqwild_tpu/ops/pallas_kernels.py:53",
         "launches": launches["sq_l2"],
         "launches_by_path": {k: p["sq_l2"] for k, p in paths.items()},
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": k1_main["kernel_ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"].split(",")[0],
         "library_ms": k1_main["library_ms"], "shape": k1_main["shape"],
         "eval_chunk": {k: k1_eval[k] for k in chunk_keys},
         "clip_chunk": {k: k1_clip[k] for k in chunk_keys},
         "moment_chunk": {k: k1_moment[k] for k in chunk_keys},
         "moment_device_chunk": {k: k1_moment_device[k] for k in chunk_keys}},
        {"name": "stem_s2d_pool", "route": "cuda", "source": "vqwild_tpu_torch/csrc/stem_pool.cu",
         "replaces": "vqwild_tpu/ops/pallas_kernels.py:152",
         "launches": launches["stem_s2d_pool"],
         "launches_by_path": {k: p["stem_s2d_pool"] for k, p in paths.items()},
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
