"""Device choice for the port's entry points.

Entry points (Predictor, table construction, model construction) run on
the card by default.  With no GPU present they raise unless the caller
asks for the CPU explicitly (as the CPU tests do); nothing falls back
silently.

On the card, ``resolve_device`` also makes the device's primary context
current on autograd's worker thread for that device, once a process.
That thread runs every backward on the device, and its first CUDA call
may be a cuBLAS product (a linear layer's backward), which finds no
current context there; PyTorch then warns and sets one itself.  The
kernels' own entry points guard their device on any thread
(``csrc/device.cuh``).
"""

from __future__ import annotations

import threading
from typing import Set, Union

import torch

DeviceLike = Union[None, str, torch.device]

_bound: Set[int] = set()
_bound_lock = threading.Lock()


def bind_autograd_worker(dev: torch.device) -> None:
    """Make ``dev``'s primary context current on autograd's worker thread
    for ``dev`` (once a process; not while a CUDA graph is captured)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    with _bound_lock:
        if index in _bound or torch.cuda.is_current_stream_capturing():
            return
        with torch.enable_grad():
            x = torch.zeros((), device=torch.device("cuda", index), requires_grad=True)
            (x * 2).backward()  # the worker thread launches grad * 2: the runtime binds the context there
        _bound.add(index)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vog_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda":
        bind_autograd_worker(dev)
    return dev
