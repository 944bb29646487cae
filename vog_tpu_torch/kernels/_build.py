"""Build and load the CUDA kernels in ``vog_tpu_torch/csrc``.

Each ``.cu`` source has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library that
is loaded with ctypes (no PyTorch headers, so a build takes seconds).
All sources compile in parallel, one nvcc process each, at first use,
into ``vog_tpu_torch/build/`` (or ``$VOG_TORCH_BUILD_DIR``).  A library's
file name carries the hash of its source, its flags and every header in
``csrc`` (``*.cuh``), so an edited source or header rebuilds.

Precision: every source builds at "highest" (3xTF32 products, fp32-level
accuracy), and the three with TF32 products build once more at "default"
(``-DVOG_ONE_PASS=1``: one TF32 pass, bf16 emitted score gradients;
``csrc/tf32.cuh``), each its own library and its own nvcc process, so the
second build adds no wall time where there are cores for it.  A wrapper
takes the library of ``config.kernel_precision()`` and counts its launches
under ``variant(name, precision)`` (``flash_attention@default``).

Head dims: ``mm_attention.cu`` builds once more for its instances past
dh 128 (``-DVOG_MM_CLUSTER=1``, the libraries ``mm_attention_cluster`` and
``mm_attention_cluster@default``: the forward's and the backward's cluster
instances, ``csrc/cluster.cuh``), so that nvcc compiles its two sets of
A = 1..8 templates in parallel (one library would take their sum, the
longest build); ``attention.cu`` holds all of its instances (DK 64 and
128, the cluster instances past 128) in one library.  At "default" it
builds a third time for ``mm_bwd_dkv_wg`` (``-DVOG_MM_WG=1``, the library
``mm_attention_wg@default``): the production recipe's emit backward at dh
<= 128, one instance, which the narrow "default" library does not hold.

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
PRECISION_FLAGS = {"highest": (), "default": ("-DVOG_ONE_PASS=1",)}
# the sources that build a second library for their cluster instances
CLUSTER_SOURCES = ("mm_attention.cu",)
CLUSTER = "cluster"
# mm_attention.cu's part of mm_bwd_dkv_wg, the one-pass emit backward at dh
# <= 128 (one library, at "default" only)
WG = "wg"
PART_FLAGS = {None: (), CLUSTER: ("-DVOG_MM_CLUSTER=1",), WG: ("-DVOG_MM_WG=1",)}
# every library: (source, precision, part: None, CLUSTER or WG); the gather
# (a byte copy) has no products
LIBRARIES = (tuple((s, "highest", None) for s in SOURCES)
             + tuple((s, "default", None) for s in SOURCES if s != "gather.cu")
             + tuple((s, p, CLUSTER) for s in CLUSTER_SOURCES for p in PRECISION_FLAGS)
             + (("mm_attention.cu", "default", WG),))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
launches: Dict[str, int] = {}


def count(name: str, precision: str = "highest") -> None:
    """One launch of kernel ``name`` at ``precision`` (counted under
    ``variant(name, precision)``)."""
    key = variant(name, precision)
    with _count_lock:
        launches[key] = launches.get(key, 0) + 1


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


def variant(name: str, precision: str) -> str:
    """A kernel's counter name at ``precision``: ``name`` at "highest",
    ``name@default`` at "default"."""
    return name if precision == "highest" else f"{name}@{precision}"


def lib_stem(src: str, precision: str, part=None) -> str:
    """The library's (and its build log's) name: ``attention``,
    ``attention@default``, ``mm_attention_cluster@default`` or
    ``mm_attention_wg@default``."""
    return variant(Path(src).stem + ("" if part is None else f"_{part}"), precision)


def _flags(precision: str, part) -> tuple:
    return PRECISION_FLAGS[precision] + PART_FLAGS[part]


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


def _lib_path(src: str, precision: str = "highest", part=None) -> Path:
    h = hashlib.sha256((CSRC / src).read_bytes())
    h.update(" ".join(_flags(precision, part)).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return build_dir() / f"{lib_stem(src, precision, part)}-{digest}.so"


def build_all() -> float:
    """Compile every library (``LIBRARIES``) that is missing, all in
    parallel; returns seconds."""
    t0 = time.perf_counter()
    with _lock:
        todo = [lib for lib in LIBRARIES if not _lib_path(*lib).exists()]
        if not todo:
            return time.perf_counter() - t0
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        started = time.time()
        for src, prec, part in todo:
            lib = _lib_path(src, prec, part)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *_flags(prec, part), "-o", str(tmp), str(CSRC / src)]
            log = out / f"{lib_stem(src, prec, part)}.log"
            with open(log, "w") as f:  # nvcc's output lands in the log as it runs
                procs.append((log, lib, tmp, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
        failed = []
        for log, lib, tmp, p in procs:
            p.wait()
            took = os.path.getmtime(log) - started  # its last line is written as nvcc ends
            if p.returncode != 0:
                failed.append(f"{log.stem}:\n{log.read_text()}")
            else:
                os.replace(tmp, lib)
            with open(log, "a") as f:
                f.write(f"[nvcc] {took:.1f} s\n")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(src: str, precision: str = "highest", part=None) -> ctypes.CDLL:
    """The loaded library of one source at ``precision`` (and, for
    ``mm_attention.cu``, its part: CLUSTER or WG), built on first use."""
    key = lib_stem(src, precision, part)
    lib = _libs.get(key)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(src, precision, part)))
                _libs[key] = lib
    return lib


def function(src: str, name: str, argtypes, precision: str = "highest", part=None) -> object:
    """The C entry point ``name`` of ``src``'s library at ``precision``,
    with its argument types declared and an int (cudaError_t) result.
    Every entry point takes the device ordinal of its tensors first (an
    int ahead of ``argtypes``): it launches under a guard that makes that
    device current on the calling thread (``csrc/device.cuh``), whichever
    thread calls it and whichever device is current there."""
    key = (lib_stem(src, precision, part), name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(src, precision, part), name)
        fn.argtypes = [ctypes.c_int, *argtypes]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


OPS_NAMESPACE = "vog"


def define_op(schema: str, cuda, cpu, fake) -> None:
    """Register the op ``vog::<schema>`` (``torch.ops.vog.<name>``): on a
    CUDA tensor ``cuda`` (the kernel's launch), on a CPU tensor ``cpu``
    (its plain version), and on a fake tensor (``torch.export``'s tracing,
    the meta device) ``fake``, which gives only the outputs' shapes and
    dtypes, so a traced tensor never reaches the launch.  Each forward
    kernel of the serving path is such an op and its wrapper calls it, so
    the live paths and an exported program take one route to the kernel."""
    name, args = schema.split("(", 1)
    qualname = f"{OPS_NAMESPACE}::{name}"
    torch.library.define(qualname, "(" + args)
    torch.library.impl(qualname, "cuda")(cuda)
    torch.library.impl(qualname, "cpu")(cpu)
    torch.library.register_fake(qualname)(fake)


def needs_grad(*ts) -> bool:
    """Whether autograd records a call on ``ts`` (None entries skipped):
    where it does not (inference, a traced export), a wrapper calls its
    forward op alone, without its ``torch.autograd.Function``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


# an emit mode's products widen a bf16 score gradient in slices of at most
# this many values (128 MB of fp32)
WIDEN_FLOATS = 1 << 25


def bmm_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, M, K) @ b ((N, K, P) or (K, P)) -> fp32 (N, M, P).  A bf16
    ``a`` (the emit modes' ds or comb at "default") is widened to fp32, as
    the JAX package's einsum promotes it, in slices of N holding at most
    WIDEN_FLOATS values (P100: 2 of the 8 (b, h) slices of 16M), and the
    product runs at the process's precision (TF32 at "default").  Not a
    bf16 product: PyTorch's would round the result to bf16, a rounding the
    JAX package does not make."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    N, M, K = a.shape
    n = max(1, WIDEN_FLOATS // (M * K))
    if n >= N:
        return torch.matmul(a.float(), b)
    out = torch.empty((N, M, b.shape[-1]), dtype=torch.float32, device=a.device)
    for i in range(0, N, n):
        torch.matmul(a[i:i + n].float(), b if b.dim() == 2 else b[i:i + n], out=out[i:i + n])
    return out


def check_outputs(name: str, *tensors) -> None:
    """Hand a backward's gradients to ``misc.checkify``'s NaN check
    (train/checkify.py §check_kernel_outputs): its dispatch mode never sees
    the values a raw kernel writes.  Nothing unless a dispatch mode is on."""
    if torch._C._len_torch_dispatch_stack():
        from vog_tpu_torch.train.checkify import check_kernel_outputs

        check_kernel_outputs(name, *tensors)


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
