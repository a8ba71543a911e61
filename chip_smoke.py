#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  (a) card    — name and power limit (nvidia-smi).
  (b) build   — nvcc builds csrc/sq_l2.cu (K1) and csrc/stem_pool.cu (K2),
                both started together; build seconds and ptxas usage.
  (c) k1      — K1 against its plain PyTorch version at the serving shapes
                and two ragged ones: rtol 1e-5 / atol 1e-3 on N(0,1) data,
                and top-30 rows identical on a gallery with planted,
                well-separated neighbours (tie-free by construction).
  (d) k2      — K2 against its plain version at [960,56,56,6]: fp32 with
                TF32 off, atol 1e-4; bf16, atol 0.05 (one bf16 ULP at
                magnitude 2).
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
  (f) kernels — one {"kernels": [...]} line.

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

K1_SHAPES = [(16, 7670, 512), (16, 100000, 512), (5, 130, 512), (300, 1000, 64)]
K2_SHAPE = (960, 56, 56, 6)
GALLERY_ROWS = 7670
EMBED_BATCHES, CLIPS, FRAMES, CROP = 16, 30, 32, 112


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


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the peak rate for the inputs' type, the larger."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


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

    from vqwild_tpu_torch.ops.distance import pairwise_sq_l2, sq_l2

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
        b_ms, b_by = bound(4.0 * (nq * d + ng * d + nq * ng), 2.0 * nq * ng * d)
        row = {"phase": "k1", "shape": [nq, ng, d], "max_abs_err": err,
               "topk_queries_checked": m, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        rows.append(row)
    return rows


def phase_k2(dev, shape):
    import torch
    import torch.nn.functional as F

    from vqwild_tpu_torch.ops.stem_pool import stem_s2d_pool, stem_s2d_pool_plain

    n, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(2)
    x32 = torch.randn(shape, generator=gen, device=dev)
    w32 = 0.1 * torch.randn(16 * c, 64, generator=gen, device=dev)
    b32 = 0.1 * torch.randn(64, generator=gen, device=dev)
    rows = []
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 0.05)):
        x, wm, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
        got, want = stem_s2d_pool(x, wm, b), stem_s2d_pool_plain(x, wm, b)
        err = (got.float() - want.float()).abs().max().item()
        if got.shape != (n, h // 2, w // 2, 64) or err > atol:
            raise AssertionError(f"K2 {dtype}: shape {tuple(got.shape)}, max err {err} > {atol}")
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
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        b_ms, b_by = bound(nbytes, 2.0 * n * h * w * 16 * c * 64, peak)
        row = {"phase": "k2", "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
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
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
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
    k2 = phase_k2(dev, K2_SHAPE)
    with tempfile.TemporaryDirectory() as workdir:
        serve = phase_serve(dev, workdir, batches=EMBED_BATCHES, clips=CLIPS, frames=FRAMES,
                            crop=CROP, gallery_rows=GALLERY_ROWS, ref_clips=2, ref_frames=4,
                            n_feature_q=32, n_clip_q=8)

    k1_main = k1[0]  # (16, 7670, 512): the smoke's gallery at a full query bucket
    k2_main = k2[0]  # fp32, the serving dtype
    emit({"kernels": [
        {"name": "sq_l2", "route": "cuda", "source": "vqwild_tpu_torch/csrc/sq_l2.cu",
         "replaces": "vqwild_tpu/ops/pallas_kernels.py:53",
         "launches": serve["launches"]["sq_l2"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": k1_main["kernel_ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": k1_main["library_ms"], "shape": k1_main["shape"]},
        {"name": "stem_s2d_pool", "route": "cuda", "source": "vqwild_tpu_torch/csrc/stem_pool.cu",
         "replaces": "vqwild_tpu/ops/pallas_kernels.py:152",
         "launches": serve["launches"]["stem_s2d_pool"],
         "max_abs_err": k2_main["max_abs_err"],
         "ms": k2_main["kernel_ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "library_ms": k2_main["library_ms"], "shape": k2_main["shape"], "dtype": "float32"},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
