"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel behind a plain ``extern "C"``
launcher. It is compiled with nvcc for ``sm_90a`` into
``vqwild_tpu_torch/_build/<name>-<hash>.so`` at first use (the hash covers
the source and the flags, so an edited source rebuilds) and loaded with
ctypes. Nothing here runs at import time: the CPU-only test machine has no
nvcc and imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCount:
    """Launches of one kernel. Thread-safe: the HTTP handler threads embed
    clips concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def add(self) -> None:
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; (proc, out, tmp)."""
    out = lib_path(name)
    if out.exists():
        return None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    with open(out.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, out, tmp


def _finish(name: str, proc, out: Path, tmp) -> None:
    if proc is None:
        return
    rc = proc.wait()
    log = out.with_suffix(".log").read_text()
    if rc != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (rc {rc}):\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one nvcc process
    each, all started together. Returns seconds per kernel (0.0 if it was
    already built)."""
    names = list(names)
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names}
        secs = {}
        for n, job in started.items():
            _finish(n, *job)
            secs[n] = 0.0 if job[0] is None else time.perf_counter() - t0
        return secs


def build_log(name: str) -> str:
    """nvcc/ptxas output of the current build (registers, shared memory)."""
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(lib_path(name)))
                _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
