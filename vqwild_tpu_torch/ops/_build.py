"""Build, bind, place and count the port's CUDA kernels: the seam that
each hand-written kernel's wrapper (``distance``, ``stem_pool``, ``conv``,
``linear``, ``attention``) plugs into.

Each ``csrc/<name>.cu`` holds one kernel behind a plain ``extern "C"``
launcher. It is compiled with nvcc for ``sm_90a`` into
``vqwild_tpu_torch/_build/<name>-<hash>.so`` at first use (the hash covers
the source, the headers of ``csrc/`` it includes and the flags, so an
edited source or header rebuilds) and loaded with ctypes (``bind``).
``on`` and ``stream`` place a launch, ``workspace`` asks a launcher's plan
for its scratch, and ``OpCounters`` counts launches. Nothing here runs at
import time: the CPU-only test machine has no nvcc and imports every
module.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence

import torch

from vqwild_tpu_torch.core import profiling

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)  # a header of SRC_DIR


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in _INCLUDE.findall(src):
        h.update(b"\0" + (SRC_DIR / header.decode()).read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


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


def bind(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    each exported symbol of ``signatures`` typed by its ``(restype,
    *argtypes)``."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(lib_path(name)))
                for symbol, (restype, *argtypes) in signatures.items():
                    fn = getattr(lib, symbol)
                    fn.restype, fn.argtypes = restype, argtypes
                _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


@functools.lru_cache(maxsize=1024)
def workspace(name: str, symbol: str, device_index: int, geo) -> int:
    """Floats of scratch that the plan ``symbol`` of the bound library
    ``name`` asks for ``geo`` on the current device, ``device_index``
    (asked once for each); a negative answer is its cudaError_t."""
    n = int(getattr(_libs[name], symbol)(*geo))
    if n < 0:
        raise RuntimeError(f"{symbol}: the plan failed with cudaError_t {-n}")
    return n


def on(dev: torch.device):
    """``dev`` made current for the launchers, where it is not already."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def stream(dev: torch.device) -> int:
    """The current stream of ``dev``, as the launchers take it."""
    return torch.cuda.current_stream(dev).cuda_stream


class OpCounters(dict):
    """An op's always-on counts, a ``profiling.Counter`` for each of its
    events (``self[event].n``; ``n`` and ``reset`` over all of them).
    ``count`` bumps one and, from the same call while the recorder is on,
    the recorder's counter ``<op>.<event>`` and, where a FLOP count or a
    byte count is given, ``<op>.flop`` or ``<op>.bytes`` (core/profiling.py)."""

    def __init__(self, op: str, events: Sequence[str]):
        super().__init__((e, profiling.Counter()) for e in events)
        self.op = op

    @property
    def n(self) -> int:
        return sum(c.n for c in self.values())

    def reset(self) -> None:
        for c in self.values():
            c.reset()

    def count(self, event: str, flop: int = 0, nbytes: int = 0) -> None:
        self[event].add()
        profiling.count(f"{self.op}.{event}")
        if flop:
            profiling.count(f"{self.op}.flop", flop)
        if nbytes:
            profiling.count(f"{self.op}.bytes", nbytes)
