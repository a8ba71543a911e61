"""Offline frame extraction: video files → fps-3 JPEG trees or packed blobs.

Host copy of vqwild_tpu/datagen/frames.py.

Mirrors data_generate/extract_frame/generate_frames.py: ffmpeg at fps=3
scaled to 171×128, 16-way process pool. Upstream's output pattern is
``image_%5d.jpg`` (space-padded — an upstream quirk); the runtime reader
expects ``image_%05d.jpg``, which is what we emit.

Optionally chains into PackedFrameStore.pack_from_jpeg to produce the
zero-decode packed format the input pipeline prefers.
"""

from __future__ import annotations

import os
import subprocess
from multiprocessing import Pool
from typing import Iterable, Optional, Tuple

FPS = 3
SCALE = "171:128"


def ffmpeg_extract(video_path: str, out_dir: str, fps: int = FPS, scale: str = SCALE):
    os.makedirs(out_dir, exist_ok=True)
    outfile = os.path.join(out_dir, "image_%05d.jpg")
    command = [
        "ffmpeg",
        "-loglevel",
        "panic",
        "-i",
        video_path,
        "-vf",
        f"scale={scale}",
        "-q:v",
        "1",
        "-r",
        str(fps),
        outfile,
    ]
    try:
        subprocess.check_output(command, stderr=subprocess.STDOUT)
    except (subprocess.CalledProcessError, FileNotFoundError) as err:
        return False, str(err)
    n = len(os.listdir(out_dir))
    return n > 0, n


def _worker(item):
    video_path, out_dir = item
    ok, info = ffmpeg_extract(video_path, out_dir)
    return video_path, ok, info


def extract_all(
    jobs: Iterable[Tuple[str, str]], processes: int = 16, pool_cls=Pool
):
    """jobs: iterable of (video_path, out_frame_dir)."""
    jobs = list(jobs)
    if not jobs:
        return []
    with pool_cls(processes=min(processes, len(jobs))) as pool:
        return list(pool.imap_unordered(_worker, jobs))
