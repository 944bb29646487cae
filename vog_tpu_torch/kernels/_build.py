"""Build and load the CUDA kernels in ``vog_tpu_torch/csrc``.

Each ``.cu`` source has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library that
is loaded with ctypes (no PyTorch headers, so a build takes seconds).
All sources compile in parallel, one nvcc process each, at first use,
into ``vog_tpu_torch/build/`` (or ``$VOG_TORCH_BUILD_DIR``).  A library's
file name carries the hash of its source and of every header in ``csrc``
(``*.cuh``), so an edited source or header rebuilds.

Also holds the per-kernel launch counters: every wrapper adds one where it
launches its kernel, and nowhere else.  A CUDA graph (train/graphs.py)
takes back the counts of its capture, whose launches do not run, and adds
them again at every replay, which runs them.
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
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("gather.cu", "attention.cu", "mm_attention.cu", "grounding_head.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
launches: Dict[str, int] = {}


def count(name: str) -> None:
    with _count_lock:
        launches[name] = launches.get(name, 0) + 1


def reset_counts() -> None:
    with _count_lock:
        launches.clear()


def take_counts_since(before: Dict[str, int]) -> Dict[str, int]:
    """Remove and return the counts added since the snapshot ``before``."""
    with _count_lock:
        delta = {k: v - before.get(k, 0) for k, v in launches.items() if v > before.get(k, 0)}
        for k, d in delta.items():
            launches[k] -= d
            if not launches[k]:
                del launches[k]
    return delta


def add_counts(delta: Dict[str, int], times: int = 1) -> None:
    with _count_lock:
        for k, d in delta.items():
            launches[k] = launches.get(k, 0) + d * times


def build_dir() -> Path:
    d = os.environ.get("VOG_TORCH_BUILD_DIR")
    return Path(d) if d else CSRC.parent / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _lib_path(src: str) -> Path:
    h = hashlib.sha256((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return build_dir() / f"{Path(src).stem}-{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing; returns seconds."""
    t0 = time.perf_counter()
    with _lock:
        todo = [s for s in SOURCES if not _lib_path(s).exists()]
        if not todo:
            return time.perf_counter() - t0
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            lib = _lib_path(src)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for src, lib, tmp, p in procs:
            log, _ = p.communicate()
            (out / f"{Path(src).stem}.log").write_text(log)
            if p.returncode != 0:
                failed.append(f"{src}:\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first use)."""
    lib = _libs.get(src)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(src)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(src)))
                _libs[src] = lib
    return lib


def function(src: str, name: str, argtypes) -> object:
    """The C entry point ``name`` of ``src``'s library, with its argument
    types declared and an int (cudaError_t) result."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(src), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s device, without
    building a ``torch.cuda.Stream`` object (a few µs a call)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    """Wrapper argument checks: device, dtype, rank and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float
