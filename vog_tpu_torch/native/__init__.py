"""Host-side native code, loaded with ctypes: the packed feature store's
threaded gather (``featpack.cpp``, a copy of the JAX package's).

The library builds with g++ at first use into the port's build directory
(``vog_tpu_torch/build/``, or ``$VOG_TORCH_BUILD_DIR``), never beside the
source; its file name carries the hash of the source and the flags, so an
edited source rebuilds, and a build lands under a temporary name and is
renamed into place, so concurrent processes never load a torn file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from vog_tpu_torch.kernels._build import build_dir

SRC = Path(__file__).resolve().parent / "featpack.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def featpack_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"libfeatpack-{h.hexdigest()[:16]}.so"


def build_featpack() -> Path:
    """Compile the featpack shared library unless it is built already."""
    out = featpack_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"], check=True)
    os.replace(tmp, out)
    return out


def load_featpack() -> ctypes.CDLL:
    """Build (if needed) and load libfeatpack with typed signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_featpack()))
        lib.fp_open.restype = ctypes.c_void_p
        lib.fp_open.argtypes = [ctypes.c_char_p]
        lib.fp_close.argtypes = [ctypes.c_void_p]
        lib.fp_size.restype = ctypes.c_uint64
        lib.fp_size.argtypes = [ctypes.c_void_p]
        lib.fp_gather.restype = ctypes.c_int
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fp_gather.argtypes = [ctypes.c_void_p, u64p, u64p, u64p, ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int64, ctypes.c_int]
        _lib = lib
        return lib
