"""Traffic and data made from the seed: the open-loop schedule, the clip
pool of the clip-query mix, the queries and the untrimmed gallery of the
moment-query mix. NumPy only, so that the load generator's process starts
without torch; ``moment_gallery`` takes torch as an argument.

Every seed gets the same work: the schedule's gaps are the exponential's
quantiles at a fixed grid, in an order drawn from a seed; the load
generator draws that order from ``DATA_SEED``, so every run sends the same
arrivals, and the run's seed chooses what each request carries.
"""

from __future__ import annotations

import io
from typing import Tuple

import numpy as np

# the role of each seeded draw; a run's generators are SeedSequence([seed, role])
ROLE_SCHEDULE, ROLE_POOL, ROLE_PICK, ROLE_WEIGHTS, ROLE_DROPOUT = 1, 2, 3, 4, 5
ROLE_GALLERY, ROLE_QUERIES, ROLE_LOADER, ROLE_SAMPLE, ROLE_PLANT = 6, 7, 8, 9, 10
ROLE_WARM = 11
DATA_SEED = 20260418  # the fixed structure every seed shares (durations, stores)


def rng(seed: int, role: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), role]))


def sub_seed(seed: int, role: int) -> int:
    """A 63-bit seed for a torch.Generator, from the run's seed and a role."""
    return int(np.random.SeedSequence([int(seed), role]).generate_state(2, np.uint64)[0]
               >> np.uint64(1))


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the start) of n = round(rate * seconds) requests:
    the first at 0, the last as the window closes, and between them a
    Poisson process's n - 1 gaps taken at the exponential's quantiles
    (i + 0.5) / (n - 1) and put in the seed's order."""
    n = max(2, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n - 1) + 0.5) / (n - 1))
    gaps = gaps * (seconds / gaps.sum())
    order = rng(seed, ROLE_SCHEDULE).permutation(n - 1)
    return np.concatenate([[0.0], np.cumsum(gaps[order])])


def picks(n: int, pool: int, seed: int) -> np.ndarray:
    """The pool entry each of n requests sends."""
    return rng(seed, ROLE_PICK).integers(0, pool, size=n)


def smooth_clip(seed: int, index: int, frames: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """One seeded low-frequency clip on the 4:2:0 wire: (y [T, s, s], uv
    [T, s/2, s/2, 2]) uint8. Normal draws on a 4x coarser grid, 127 + 60
    tanh luma and 128 + 30 tanh chroma: in gamut, so no decode clips."""
    r = np.random.default_rng(np.random.SeedSequence([int(seed), ROLE_POOL, index]))
    base = r.standard_normal((frames, size // 4, size // 4), np.float32)
    y = base.repeat(4, axis=1).repeat(4, axis=2)
    y = np.clip(127.0 + 60.0 * np.tanh(y), 0, 255).astype(np.uint8)
    c = size // 2
    uvb = r.standard_normal((frames, -(-c // 4), -(-c // 4), 2), np.float32)
    uv = uvb.repeat(4, axis=1).repeat(4, axis=2)[:, :c, :c]
    uv = np.clip(128.0 + 30.0 * np.tanh(uv), 0, 255).astype(np.uint8)
    return y, uv


def npz_body(y: np.ndarray, uv: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, y=y, uv=uv)
    return buf.getvalue()


def unit_rows(r: np.random.Generator, n: int, d: int, nonneg: bool = False) -> np.ndarray:
    a = r.standard_normal((n, d), np.float32)
    if nonneg:
        a = np.abs(a)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def clip_gallery(seed: int, rows: int, dim: int) -> np.ndarray:
    """The clip-query gallery: non-negative unit rows, as the trunk's
    time-pooled, normalized ReLU features are."""
    return unit_rows(rng(seed, ROLE_GALLERY), rows, dim, nonneg=True)


def moment_queries(seed: int, n: int, dim: int) -> np.ndarray:
    return unit_rows(rng(seed, ROLE_QUERIES), n, dim)


def video_durations(videos: int) -> np.ndarray:
    """Untrimmed durations, s: 60 + 170 x Beta(1.5, 2.75) (mean 120 s,
    skewed short as ActivityNet's are), the same for every seed."""
    return 60.0 + 170.0 * rng(DATA_SEED, ROLE_GALLERY).beta(1.5, 2.75, videos)


def moment_windows(durations: np.ndarray, clip_sec: int, max_clips: int):
    """Every moment window: for n in 1..max_clips clips, a start every
    ``clip_sec`` s in range(0, int(duration) - clip_sec * n). Returns
    (video [W], first clip [W], clips [W], start_sec [W], end_sec [W],
    clips per video [V])."""
    vid, first, count = [], [], []
    n_clips = np.array([int(d) // clip_sec for d in durations], np.int64)
    for v, d in enumerate(durations):
        for n in range(1, max_clips + 1):
            starts = np.arange(0, int(d) - clip_sec * n, clip_sec) // clip_sec
            vid.append(np.full(starts.size, v))
            first.append(starts)
            count.append(np.full(starts.size, n))
    vid, first, count = (np.concatenate(a).astype(np.int64) for a in (vid, first, count))
    start = (first * clip_sec).astype(np.float64)
    return vid, first, count, start, start + count * clip_sec, n_clips


def moment_gallery(torch, device, seed: int, durations: np.ndarray, queries: np.ndarray,
                   clip_sec: int, max_clips: int, planted_videos: int, chunk: int = 1 << 18):
    """The untrimmed gallery on ``device``: one unit feature per clip_sec
    clip of every video; for each query, ``planted_videos`` videos get a
    span of 3-12 clips near it (unit(q + noise / 2)); a window's feature is
    the unit mean of its clips' (float64 sums). Returns (feats [W, D] fp32
    on the device, windows as ``moment_windows`` gives them)."""
    vid, first, count, start, end, n_clips = moment_windows(durations, clip_sec, max_clips)
    offsets = np.concatenate([[0], np.cumsum(n_clips)])
    total, dim = int(offsets[-1]), queries.shape[1]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, ROLE_GALLERY))
    tape = torch.randn(total, dim, generator=gen, device=device, dtype=torch.float64)
    r = rng(seed, ROLE_PLANT)
    q = torch.from_numpy(queries.astype(np.float64)).to(device)
    rows, qidx = [], []
    for j in range(queries.shape[0]):
        for v in r.choice(len(durations), size=planted_videos, replace=False):
            span = int(r.integers(3, 13))
            s0 = int(r.integers(0, max(1, n_clips[v] - span)))
            rows.append(np.arange(offsets[v] + s0, offsets[v] + min(s0 + span, n_clips[v])))
            qidx.append(np.full(rows[-1].size, j))
    rows, qidx = np.concatenate(rows), np.concatenate(qidx)
    # a clip planted twice keeps its last query: an index_put with repeated
    # rows is not deterministic on the card
    last = rows.size - 1 - np.unique(rows[::-1], return_index=True)[1]
    rows, qidx = rows[last], qidx[last]
    noise = torch.randn(rows.size, dim, generator=gen, device=device, dtype=torch.float64)
    tape = tape / tape.norm(dim=1, keepdim=True)
    noise = noise / noise.norm(dim=1, keepdim=True)
    tape[torch.from_numpy(rows).to(device)] = q[torch.from_numpy(qidx).to(device)] + 0.5 * noise
    tape = tape / tape.norm(dim=1, keepdim=True)
    cs = torch.cat([torch.zeros(1, dim, dtype=torch.float64, device=device),
                    torch.cumsum(tape, dim=0)])
    del tape
    lo = torch.from_numpy(offsets[vid] + first).to(device)
    hi = lo + torch.from_numpy(count).to(device)
    feats = torch.empty(vid.size, dim, dtype=torch.float32, device=device)
    for a in range(0, vid.size, chunk):
        w = cs[hi[a:a + chunk]] - cs[lo[a:a + chunk]]
        feats[a:a + chunk] = (w / w.norm(dim=1, keepdim=True)).float()
    return feats, (vid, first, count, start, end, n_clips)


def window_row(video: np.ndarray, start_sec: np.ndarray, end_sec: np.ndarray,
               durations: np.ndarray, clip_sec: int, max_clips: int) -> np.ndarray:
    """The gallery row of each (video, start, end) window, -1 where no such
    window exists (the inverse of ``moment_windows``' order)."""
    counts = []
    for d in durations:
        counts.append([len(range(0, int(d) - clip_sec * n, clip_sec))
                       for n in range(1, max_clips + 1)])
    counts = np.asarray(counts, np.int64)  # [V, max_clips]
    base = np.concatenate([[0], np.cumsum(counts.sum(1))])[:-1]
    within = np.concatenate([np.zeros((len(durations), 1), np.int64),
                             np.cumsum(counts, axis=1)], axis=1)
    n = np.rint((end_sec - start_sec) / clip_sec).astype(np.int64)
    s = np.rint(start_sec / clip_sec).astype(np.int64)
    ok = (n >= 1) & (n <= max_clips) & (video >= 0) & (video < len(durations))
    v, nn = np.where(ok, video, 0), np.clip(n, 1, max_clips)
    ok &= (s >= 0) & (s < counts[v, nn - 1]) & (np.abs(start_sec - s * clip_sec) < 1e-6)
    return np.where(ok, base[v] + within[v, nn - 1] + s, -1)
