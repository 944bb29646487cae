"""Device choice for the port's entry points.

Entry points (Predictor, table construction, model construction) run on
the card by default.  With no GPU present they raise unless the caller
asks for the CPU explicitly (as the CPU tests do); nothing falls back
silently.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vog_tpu_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
