"""ctypes bindings for the port's native ranking engine (``engine.cpp``
beside this file, a copy of vqwild_tpu/native/engine.cpp).

The engine is host C++: g++ builds it at first use into the git-ignored
``vqwild_tpu_torch/_build/``, under a name keyed by the source's and the
flags' hash and by the host CPU's signature (it compiles with
``-march=native``). Every build compiles into a temp file of its own and
publishes it with ``os.replace``, so threads and processes that start it at
once never load a half-written library. ``VQWILD_NO_NATIVE=1``, or a host
without g++, leaves the callers (ops/nms.py, retrieval/moment.py) on their
numpy paths, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from vqwild_tpu_torch.core.hostsig import host_cpu_signature
from vqwild_tpu_torch.core.logging import get_logger

log = get_logger("native")

_SRC = Path(__file__).resolve().parent / "engine.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def lib_path(build_dir=BUILD_DIR) -> Path:
    tag = hashlib.sha256(_SRC.read_bytes() + "\0".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir) / f"vq_native-{tag}-{host_cpu_signature()}.so"


def build(build_dir=BUILD_DIR) -> Path:
    """Compile engine.cpp into ``build_dir`` unless it is built; → the
    library's path. Raises CalledProcessError (with g++'s output) or
    FileNotFoundError (no g++)."""
    out = lib_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def open_library(build_dir=BUILD_DIR) -> ctypes.CDLL:
    """Build (if needed) and load the engine from ``build_dir``, with every
    entry point's argument types declared."""
    lib = ctypes.CDLL(str(build(build_dir)))
    i32p = ctypes.POINTER(ctypes.c_int)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.vq_version.argtypes = []
    lib.vq_version.restype = ctypes.c_int
    lib.vq_temporal_nms.restype = ctypes.c_int
    lib.vq_temporal_nms.argtypes = [f32p, ctypes.c_int, ctypes.c_float, i32p]
    lib.vq_moment_batch.restype = ctypes.c_int
    lib.vq_moment_batch.argtypes = [
        f32p,  # scores [Q, n]
        i32p,  # video_idx
        f32p,  # start
        f32p,  # end
        i32p,  # hit_label
        f32p,  # hit_iou
        i32p,  # q_label
        i32p,  # ignore_vids [Q, max_ig]
        ctypes.c_int,  # max_ig
        ctypes.c_int,  # Q
        ctypes.c_int,  # n
        ctypes.c_float,  # nms_thresh
        ctypes.c_float,  # tiou_thresh
        i32p,  # rn
        ctypes.c_int,  # n_rn
        ctypes.c_int,  # robust
        ctypes.c_int,  # n_threads
        f64p,  # ap_out [Q]
        f64p,  # recalls_out [Q, n_rn]
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if os.environ.get("VQWILD_NO_NATIVE") == "1":
        return None
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = open_library()
            except subprocess.CalledProcessError as e:
                log.warning("native engine build failed; numpy postprocess instead:\n%s",
                            e.stderr)
                _failed = True
            except OSError as e:  # no g++, or the library does not load
                log.warning("native engine unavailable (%s); numpy postprocess instead", e)
                _failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native engine is not available (VQWILD_NO_NATIVE=1 or no g++)")
    return lib


def _as(arr, dtype):
    return np.ascontiguousarray(arr, dtype=dtype)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def temporal_nms(dets: np.ndarray, thresh: float) -> List[int]:
    """[n, 3] (start, end, score) rows → kept row indices, descending score
    (ops/nms.py semantics)."""
    lib = _require()
    dets = _as(dets, np.float32)
    if dets.ndim != 2 or dets.shape[1] != 3:
        raise ValueError(f"dets must be [n, 3], got {dets.shape}")
    keep = np.empty(dets.shape[0], np.int32)
    n = lib.vq_temporal_nms(
        _ptr(dets, ctypes.c_float), dets.shape[0], thresh, _ptr(keep, ctypes.c_int)
    )
    return keep[:n].tolist()


def moment_batch(
    scores: np.ndarray,  # [Q, n] float32
    video_idx: np.ndarray,  # [n] int32
    start_sec: np.ndarray,  # [n]
    end_sec: np.ndarray,  # [n]
    hit_label: np.ndarray,  # [n] int32 (label ids, -1 for none)
    hit_iou: np.ndarray,  # [n]
    q_label: np.ndarray,  # [Q] int32
    ignore_vids: np.ndarray,  # [Q, max_ig] int32, -1 padded
    nms_thresh: float,
    tiou_thresh: float,
    r_at_n: Sequence[int],
    robust: bool,
    n_threads: int = 8,
):
    """→ (ap [Q] f64, recalls [Q, len(r_at_n)] f64). Arrays already of the
    engine's dtypes and contiguous are passed without a copy."""
    lib = _require()
    scores = _as(scores, np.float32)
    if scores.ndim != 2:
        raise ValueError(f"scores must be [Q, n], got {scores.shape}")
    q, n = scores.shape
    video_idx = _as(video_idx, np.int32)
    start_sec = _as(start_sec, np.float32)
    end_sec = _as(end_sec, np.float32)
    hit_label = _as(hit_label, np.int32)
    hit_iou = _as(hit_iou, np.float32)
    q_label = _as(q_label, np.int32)
    ignore_vids = _as(ignore_vids, np.int32)
    rn = _as(list(r_at_n), np.int32)
    if any(a.shape != (n,) for a in (video_idx, start_sec, end_sec, hit_label, hit_iou)):
        raise ValueError(f"per-moment arrays must all be [{n}]")
    if q_label.shape != (q,) or ignore_vids.ndim != 2 or ignore_vids.shape[0] != q:
        raise ValueError(f"q_label {q_label.shape}, ignore_vids {ignore_vids.shape} for Q = {q}")
    ap = np.empty(q, np.float64)
    recalls = np.empty((q, len(rn)), np.float64)
    lib.vq_moment_batch(
        _ptr(scores, ctypes.c_float),
        _ptr(video_idx, ctypes.c_int),
        _ptr(start_sec, ctypes.c_float),
        _ptr(end_sec, ctypes.c_float),
        _ptr(hit_label, ctypes.c_int),
        _ptr(hit_iou, ctypes.c_float),
        _ptr(q_label, ctypes.c_int),
        _ptr(ignore_vids, ctypes.c_int),
        ignore_vids.shape[1],
        q,
        n,
        nms_thresh,
        tiou_thresh,
        _ptr(rn, ctypes.c_int),
        len(rn),
        int(robust),
        n_threads,
        _ptr(ap, ctypes.c_double),
        _ptr(recalls, ctypes.c_double),
    )
    return ap, recalls
