"""The eval gather across processes (counterpart of
vog_tpu/train/multihost.py).

Reference parity: the reference's DDP eval all-reduces the metric sums
and gathers each rank's prediction pickle on rank 0.  Here every rank
ends with both: the additive sums summed over the ranks in float32, and
the prediction lists concatenated in rank order, each rank's list riding
as its pickled bytes padded to the longest (the JAX package's
``process_allgather`` of padded byte arrays).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _device(group) -> torch.device:
    """Where a collective of ``group`` takes its tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_eval(sums: Dict[str, float], preds: List[Dict], group=None) -> Tuple[Dict[str, float], List[Dict]]:
    """-> (``sums`` summed over the ranks of ``group`` (the default group
    when None; the Learner passes its mesh's data group, whose ranks hold
    different rows), every rank's ``preds`` concatenated in rank order).
    With no process group it is the identity."""
    if not dist.is_initialized():
        return dict(sums), list(preds)
    group = group if group is not None else dist.group.WORLD
    dev = _device(group)
    world = dist.get_world_size(group)
    keys = sorted(sums)
    out_sums: Dict[str, float] = {}
    if keys:  # sums may be {} (a gather of the predictions alone)
        vals = torch.tensor([sums[k] for k in keys], dtype=torch.float32, device=dev)
        got = torch.empty(world * len(keys), dtype=torch.float32, device=dev)
        dist.all_gather_into_tensor(got, vals, group=group)
        tot = got.cpu().numpy().reshape(world, len(keys)).sum(axis=0, dtype=np.float32)
        out_sums = {k: float(tot[i]) for i, k in enumerate(keys)}

    blob = np.frombuffer(pickle.dumps(preds), np.uint8)
    n = torch.tensor([blob.size], dtype=torch.int64, device=dev)
    sizes_t = torch.empty(world, dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(sizes_t, n, group=group)
    sizes = sizes_t.cpu().tolist()
    pad = max(sizes)
    padded = torch.zeros(pad, dtype=torch.uint8)
    padded[: blob.size] = torch.from_numpy(blob.copy())
    blobs = torch.empty(world * pad, dtype=torch.uint8, device=dev)
    dist.all_gather_into_tensor(blobs, padded.to(dev), group=group)
    blobs = blobs.cpu().numpy().reshape(world, pad)
    out_preds: List[Dict] = []
    for i, size in enumerate(sizes):
        out_preds.extend(pickle.loads(blobs[i, :size].tobytes()))
    return out_sums, out_preds
