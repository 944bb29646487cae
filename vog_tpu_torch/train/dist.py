"""Data parallelism across processes, one card a process (counterpart of
vog_tpu/train/dist.py, its ``data`` axis).

The JAX package runs one program over a ``('data', 'model')`` mesh and
XLA inserts the gradient's psum; here each rank is a process of its own
(``torchrun --nproc-per-node N``, rank r on ``cuda:$LOCAL_RANK``) and the
step issues its collectives itself, on the one flat gradient and on the
loss's counts (train/state.py), so they are what XLA's psum is, and a
CUDA graph captures them (NCCL collectives are capturable; gloo's are
not, and a graphed dispatch on a gloo group raises).  No
``DistributedDataParallel``: its hooks fight the flat gradient buffer and
need a side-stream construction under whole-step capture.

``Mesh`` holds the rank, the world size and the data group; the
``model`` axis (tensor parallelism, the sequence-parallel ring) is not
ported, so its size is 1.  Rank r owns rows [r*bs, (r+1)*bs) of every
global batch of ``bs * world`` rows (``local_batch_rows``), the
DistributedSampler's contiguous split.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vog_tpu_torch.device import DeviceLike, resolve_device

HALF_KEYS = ("props", "seg_feats")  # bulky features; boxes/targets stay f32


@dataclass(frozen=True)
class Mesh:
    """The data axis: this process's ``rank`` among ``world``, and the
    process group (None without one: a single process, every collective
    the identity).  ``backend`` is the group's ("nccl" or "gloo")."""

    rank: int = 0
    world: int = 1
    group: Any = None
    backend: str = ""
    model: int = 1

    def _staged(self, t: torch.Tensor) -> bool:
        """gloo takes host tensors: a card tensor goes through a host copy,
        which a CUDA graph cannot hold."""
        if self.backend == "nccl" or not t.is_cuda:
            return False
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"a {self.backend} process group cannot be captured in a CUDA graph: use nccl on "
                               "the card, or the eager step")
        return True

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axis, in place."""
        if self.group is None:
            return t
        if self._staged(t):
            h = t.cpu()
            dist.all_reduce(h, group=self.group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` stacked along dim 0 in rank order."""
        if self.group is None:
            return t
        src = t.contiguous().cpu() if self._staged(t) else t.contiguous()
        out = src.new_empty((self.world * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.to(t.device)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axis and keep this rank's block of dim 0
        (its length over ``world``)."""
        if self.group is None:
            return t
        src = t.contiguous().cpu() if self._staged(t) else t.contiguous()
        out = src.new_empty((src.shape[0] // self.world,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return out.to(t.device)

    def barrier(self) -> None:
        if self.group is not None:
            ids = [torch.cuda.current_device()] if self.backend == "nccl" else None
            dist.barrier(group=self.group, device_ids=ids)


def init_distributed(cfg, device: DeviceLike = None) -> torch.device:
    """The counterpart of ``jax.distributed.initialize()`` under
    ``misc.multihost``: a process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``),
    ``nccl`` on the card (this rank's card is ``cuda:$LOCAL_RANK``) and
    ``gloo`` when the caller asks for the CPU.  A group that exists is
    kept.  -> the device this process runs on (``device`` resolved, with
    the local rank's index on the card)."""
    dev = torch.device("cuda" if device is None else device)
    if not cfg.misc.multihost:
        return resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"misc.multihost=true needs torchrun's environment ({', '.join(missing)} unset): "
                               "launch with torchrun --nproc-per-node N")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def make_mesh(cfg) -> Mesh:
    """The data axis of this run (``vog_tpu/train/dist.py §make_mesh``):
    ``misc.mesh_data`` -1 is the world size, any other value must equal
    it; more than one rank needs ``misc.multihost`` (the port runs one
    process a card, not one process over several); ``misc.mesh_model`` is
    1."""
    m = cfg.misc
    if m.mesh_model != 1:
        raise ValueError(f"misc.mesh_model={m.mesh_model}: the model axis is not ported (tensor parallelism "
                         "and the sequence-parallel ring); the port runs misc.mesh_model=1")
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    d = m.mesh_data if m.mesh_data > 0 else world
    if d > 1 and not m.multihost:
        raise ValueError(f"misc.mesh_data={d} without misc.multihost: the port runs one process a card; launch "
                         "torchrun --nproc-per-node N with misc.multihost=true")
    if m.multihost and group is None:
        raise RuntimeError("misc.multihost=true: call init_distributed(cfg) before make_mesh")
    if d != world:
        raise ValueError(f"misc.mesh_data={m.mesh_data} but the world has {world} processes: set "
                         f"misc.mesh_data to {world} or -1")
    backend = dist.get_backend(group) if group is not None else ""
    return Mesh(rank=rank, world=world, group=group, backend=str(backend))


def local_batch_rows(mesh: Mesh, global_bs: int) -> Tuple[int, int]:
    """(start, stop): the rows of every global batch that this rank owns."""
    if global_bs % mesh.world:
        raise ValueError(f"a global batch of {global_bs} rows does not split over {mesh.world} ranks")
    bs = global_bs // mesh.world
    return mesh.rank * bs, (mesh.rank + 1) * bs


def shard_batch_local(batch: Dict[str, np.ndarray], device: DeviceLike, half_feats: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """A rank's local rows (``loader.local_rows``) onto its card; with
    ``half_feats`` the features travel and stay as bf16."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
        out[k] = t.to(torch.bfloat16) if half_feats and k in HALF_KEYS else t
    return out


def stack_shard_batches_local(batches: List[Dict[str, np.ndarray]], device: DeviceLike,
                              half_feats: bool = False) -> Dict[str, torch.Tensor]:
    """K local batches -> one (K, bs, ...) stack on the card: one copy a
    field for a fused dispatch's K steps."""
    return shard_batch_local({k: np.stack([b[k] for b in batches]) for k in batches[0]}, device, half_feats)
