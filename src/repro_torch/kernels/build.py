"""Build and load the hand-written CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface under ``build/kernels/`` at the repository
root, and loaded with ctypes.  A library's file name carries the hash of its
source and flags, so an edited source is rebuilt at first use and an
unchanged one is reused.  All missing libraries are compiled at once, one
``nvcc`` process per source, started together.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("traverse", "cache_probe", "range_scan", "paged_gather")
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel and nowhere else.
launches: Dict[str, int] = {
    "get": 0,
    "cache_probe_p2": 0,
    "cache_probe_p1": 0,
    "range_walk": 0,
    "paged_gather": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update((CSRC / "common.cuh").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library in parallel; returns the seconds spent."""
    todo = [(n, _lib_path(n)) for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append(
            (name, out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        )
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        build_all()
        _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return _libs[name]


_functions: Dict[str, object] = {}


def function(name: str, symbol: str, *, n_ptrs: int, n_ints: int):
    """C entry ``symbol`` of ``csrc/<name>.cu``: ``n_ptrs`` pointers, then
    ``n_ints`` ints, then the stream; returns the ``cudaError_t``."""
    key = f"{name}.{symbol}"
    if key not in _functions:
        fn = getattr(lib(name), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def pointers(tensors, device):
    """Device pointers of the kernel's operands, after checking that each is
    a contiguous tensor on ``device`` of a 32-bit or bool type."""
    out = []
    for t in tensors:
        if t.device != device:
            raise ValueError(f"kernel operand on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.dtype not in (torch.int32, torch.float32, torch.bool):
            raise TypeError(f"kernel operand of type {t.dtype}")
        out.append(ctypes.c_void_p(t.data_ptr()))
    return out


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
