"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries go to ``build/`` at the repository root,
named by a hash of their sources and flags so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built at import time: the first
launch builds what it needs, and ``build()`` builds every source at once
with one ``nvcc`` per source running in parallel.

Every C entry point takes pointers and the CUDA stream as ``void*``, returns
``cudaGetLastError()`` after its launch, and ``check`` raises on non-zero.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, MutableMapping, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("jacobi3d", "jacobi3d_halo", "residual_norm", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}

#: every wrapper module's launch counters (its ``LAUNCHES``, and
#: ``LAUNCH_SHAPES`` where it keeps one), registered at import, so that a
#: ``CountedGraph``'s replays can count the launches it captured
COUNTERS: List[MutableMapping] = []

#: ctypes argument codes used in the ``signatures`` tables of the wrappers
PTR, INT, LONG, DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> List[str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the compiler logs (register
    and spill counts from ``-Xptxas -v``); raises with the log of a source
    that fails, after every compiler has exited."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {out.name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        logs.append(log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` and every ``restype`` an int."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def register_counters(*counters: MutableMapping) -> None:
    """Register a wrapper module's launch counters in ``COUNTERS``."""
    COUNTERS.extend(counters)


def _snapshot() -> List[Dict]:
    return [dict(c) for c in COUNTERS]


def _add(delta: List[Dict], sign: int) -> None:
    for c, d in zip(COUNTERS, delta):
        for k, v in d.items():
            c[k] += sign * v


class CountedGraph:
    """A CUDA graph whose every replay adds the kernel launches its capture
    recorded to the registered counters.  A capture launches nothing, so
    ``capture`` takes back what the wrappers counted while it ran."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self._delta: List[Dict] = []

    @contextlib.contextmanager
    def capture(self):
        before = _snapshot()
        with torch.cuda.graph(self.graph):
            yield
        before += [{}] * (len(COUNTERS) - len(before))
        self._delta = [{k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
                       for c, b in zip(COUNTERS, before)]
        _add(self._delta, -1)

    def replay(self) -> None:
        self.graph.replay()
        _add(self._delta, 1)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors must all be on the CPU or on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    return True


#: the running counting modes of ``launch.hlo_analysis``: a dispatch trace
#: cannot see inside a kernel launched through ctypes, so the wrapper (or,
#: on ``meta``, the dispatcher) reports the kernel's work here
WORK_SINKS: List[List[float]] = []


def report_work(flops: float, nbytes: float) -> None:
    """Add a kernel's operations and the bytes it must move to every
    running counting mode."""
    for sink in WORK_SINKS:
        sink[0] += flops
        sink[1] += nbytes
