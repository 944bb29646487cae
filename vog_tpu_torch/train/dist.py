"""The mesh of processes, one card a process (counterpart of
vog_tpu/train/dist.py): data parallelism on its ``data`` axis, tensor
parallelism and the sequence-parallel ring on its ``model`` axis.

The JAX package runs one program over a ``('data', 'model')`` mesh and
XLA inserts the collectives; here each rank is a process of its own
(``torchrun --nproc-per-node N``, rank r on ``cuda:$LOCAL_RANK``) and the
code issues its collectives itself: the step on the one flat gradient and
the loss's counts (train/state.py), the model's tensor-parallel layers
(model/parallel.py) and the ring (kernels/ring_attention.py).  A CUDA
graph captures them (NCCL collectives are capturable; gloo's are not, and
a graphed dispatch on a gloo group raises).  No
``DistributedDataParallel``: its hooks fight the flat gradient buffer and
need a side-stream construction under whole-step capture.

``Mesh`` holds the rank, the world and the two axes' groups.  Data index
i owns rows [i*bs, (i+1)*bs) of every global batch of ``bs * data`` rows
(``local_batch_rows``), the DistributedSampler's contiguous split; the
model ranks of a data index hold the same rows.  ``shard_state_dict`` /
``gather_state_dict`` are ``param_shardings``' layout: the wide
projections column- or row-sharded over the model axis (``tp_rule``), the
rest whole on every rank.  The sequence-parallel switch is explicit:
``get_model(..., mesh=)`` runs the ring when ``mdl.sp_attention`` is on
and the mesh's model axis is longer than 1 (the JAX package's
``set_sequence_parallel`` installs a module global).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vog_tpu_torch.device import DeviceLike, resolve_device

HALF_KEYS = ("props", "seg_feats")  # bulky features; boxes/targets stay f32


@dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh of processes: this process's global ``rank``
    among ``world``, the world's process group (None without one: a single
    process, every collective the identity) and its ``backend`` ("nccl" or
    "gloo"); ``model`` ranks a data index.  Rank r is data index r //
    model and model index r % model (the model axis varies fastest, as the
    JAX package reshapes its devices (d, m)).  ``data_group`` holds the
    ranks of this rank's model index, ``model_group`` those of its data
    index (``model_ranks``, their global ranks in model-index order); a
    group of one rank is None."""

    rank: int = 0
    world: int = 1
    group: Any = None
    backend: str = ""
    model: int = 1
    data_group: Any = None
    model_group: Any = None
    model_ranks: Tuple[int, ...] = (0,)

    @property
    def data(self) -> int:
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def _group(self, axis: str):
        return {"data": self.data_group, "model": self.model_group, "world": self.group}[axis]

    def _staged(self, t: torch.Tensor) -> bool:
        """gloo takes host tensors: a card tensor goes through a host copy,
        which a CUDA graph cannot hold."""
        if self.backend == "nccl" or not t.is_cuda:
            return False
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"a {self.backend} process group cannot be captured in a CUDA graph: use nccl on "
                               "the card, or the eager step")
        return True

    def all_reduce_(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum ``t`` over ``axis`` ("data", "model" or "world"), in place."""
        group = self._group(axis)
        if group is None:
            return t
        if self._staged(t):
            h = t.cpu()
            dist.all_reduce(h, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The ranks' ``t`` of ``axis`` stacked along dim 0 in index order."""
        group = self._group(axis)
        if group is None:
            return t
        src = t.contiguous().cpu() if self._staged(t) else t.contiguous()
        n = dist.get_world_size(group)
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.to(t.device)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axis and keep this rank's block of dim 0
        (its length over ``data``)."""
        if self.data_group is None:
            return t
        src = t.contiguous().cpu() if self._staged(t) else t.contiguous()
        out = src.new_empty((src.shape[0] // self.data,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=self.data_group)
        return out.to(t.device)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """The ring step of the model axis: ``t`` goes to the next model
        index, (i + 1) % model; -> the previous index's ``t``."""
        if self.model_group is None:
            return t
        staged = self._staged(t)
        src = t.contiguous().cpu() if staged else t.contiguous()
        out = torch.empty_like(src)
        i, m = self.model_index, self.model
        ops = [dist.P2POp(dist.isend, src, self.model_ranks[(i + 1) % m], self.model_group),
               dist.P2POp(dist.irecv, out, self.model_ranks[(i - 1) % m], self.model_group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out.to(t.device) if staged else out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Model index 0's ``t`` on every rank of the model group, in place."""
        if self.model_group is None:
            return t
        if self._staged(t):
            h = t.cpu()
            dist.broadcast(h, self.model_ranks[0], group=self.model_group)
            t.copy_(h)
        else:
            dist.broadcast(t, self.model_ranks[0], group=self.model_group)
        return t

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
    """The (data, model) mesh of this run (``vog_tpu/train/dist.py
    §make_mesh``): ``misc.mesh_model`` m ranks a data index and
    ``misc.mesh_data`` d data indices (-1: the world over m), d x m equal
    to the world; more than one rank needs ``misc.multihost`` (the port
    runs one process a card, not one process over several).  m must
    divide ``mdl.n_heads``, ``mdl.vis_dim`` and the FFN's hidden width.
    Every rank creates every data and model group, in the same order."""
    m, mdl = cfg.misc, cfg.mdl
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    mm = int(m.mesh_model)
    if mm < 1 or world % mm:
        raise ValueError(f"misc.mesh_model={mm} does not divide the world of {world} processes")
    d = m.mesh_data if m.mesh_data > 0 else world // mm
    if d * mm > 1 and not m.multihost:
        axes = f"misc.mesh_data={d}" + ("" if mm == 1 else f" x misc.mesh_model={mm}")
        raise ValueError(f"{axes} without misc.multihost: the port runs one process a card; launch torchrun "
                         "--nproc-per-node N with misc.multihost=true")
    if m.multihost and group is None:
        raise RuntimeError("misc.multihost=true: call init_distributed(cfg) before make_mesh")
    if d * mm != world:
        raise ValueError(f"misc.mesh_data={m.mesh_data} x misc.mesh_model={mm} but the world has {world} "
                         f"processes: set misc.mesh_data to {world // mm} or -1")
    for key, width in (("mdl.n_heads", mdl.n_heads), ("mdl.vis_dim", mdl.vis_dim),
                       ("mdl.ff_mult * mdl.vis_dim", mdl.ff_mult * mdl.vis_dim)):
        if width % mm:
            raise ValueError(f"misc.mesh_model={mm} does not divide {key} = {width}: the model axis splits it")
    backend = str(dist.get_backend(group)) if group is not None else ""
    if mm == 1:
        return Mesh(rank=rank, world=world, group=group, backend=backend,
                    data_group=group if world > 1 else None)
    data_group = model_group = None
    for j in range(mm):  # the data groups: one a model index
        g = dist.new_group([i * mm + j for i in range(d)])
        if rank % mm == j and d > 1:
            data_group = g
    for i in range(d):  # the model groups: one a data index
        g = dist.new_group(list(range(i * mm, (i + 1) * mm)))
        if rank // mm == i:
            model_group = g
    first = rank // mm * mm
    return Mesh(rank=rank, world=world, group=group, backend=backend, model=mm, data_group=data_group,
                model_group=model_group, model_ranks=tuple(range(first, first + mm)))


def local_batch_rows(mesh: Mesh, global_bs: int) -> Tuple[int, int]:
    """(start, stop): the rows of every global batch that this rank's data
    index owns (the model ranks of a data index hold the same rows)."""
    if global_bs % mesh.data:
        raise ValueError(f"a global batch of {global_bs} rows does not split over {mesh.data} data indices")
    bs = global_bs // mesh.data
    return mesh.data_index * bs, (mesh.data_index + 1) * bs


# --- parameter partitioning (vog_tpu/train/dist.py §param_shardings) -------
# Keyed on module path suffixes of the state dict's keys, the JAX package's
# rules with flax's names: "kernel" is a Linear's weight.
_COL_SHARDED = (  # (in, out) kernels sharded on the output dim
    ("prop_enc", "prop_proj"),
    ("seg_enc", "seg_proj"),
    ("qkv",),
    ("ff1",),
    ("fuse_cross",),  # matches no leaf: the fused head names it fuse_cross_kernel
)
_ROW_SHARDED = (  # kernels sharded on the input dim (follow a col-shard)
    ("out",),
    ("ff2",),
)


def ring_block(module: str, cfg) -> bool:
    """Whether the attention block at ``module`` (a state-dict module path)
    runs the sequence-parallel ring under ``mdl.sp_attention``: the object
    transformer's, and the multimodal transformer's but the decomposed
    first layer's (it keeps the mm kernel, as in the JAX package)."""
    parts = module.split(".")
    if len(parts) < 4 or parts[3] != "attn" or parts[0] not in ("obj_tx", "mm_tx"):
        return False
    return parts[0] == "obj_tx" or not (cfg.mdl.decomposed_mm and parts[2] == "0")


def tp_rule(key: str, cfg) -> Optional[str]:
    """How tensor parallelism lays out the state-dict entry ``key``:
    "col" (a column-sharded Linear's weight and bias: this rank's block
    of output features), "qkv" (the same, by heads: this rank's block of
    each of q, k and v), "row" (a row-sharded Linear's weight: its block
    of input features; the bias stays whole, added after the reduction),
    or None (whole on every rank).  Under ``mdl.sp_attention`` the ring
    blocks' qkv and out stay whole: the ring shards tokens, not heads."""
    module, _, leaf = key.rpartition(".")
    if leaf not in ("weight", "bias"):
        return None
    if cfg.mdl.sp_attention and ring_block(module, cfg):
        return None
    path = tuple(module.split("."))
    for suf in _COL_SHARDED:
        if path[-len(suf):] == suf:
            return "qkv" if suf == ("qkv",) else "col"
    for suf in _ROW_SHARDED:
        if path[-len(suf):] == suf:
            return "row" if leaf == "weight" else None
    return None


def partial_grad(key: str, cfg) -> bool:
    """Whether a whole parameter gets a partial gradient on each model rank,
    summed over the model axis: the relative-bias tables (each rank uses
    its heads' rows, or, on the ring, its token block's pairs), and under
    ``mdl.sp_attention`` the ring blocks' qkv and out (each rank projects
    its token block)."""
    module, _, leaf = key.rpartition(".")
    if leaf == "rpe_table":
        return True
    return bool(cfg.mdl.sp_attention) and ring_block(module, cfg) and module.rsplit(".", 1)[-1] in ("qkv", "out")


def shard_tensor(t: torch.Tensor, rule: Optional[str], mesh: Mesh) -> torch.Tensor:
    """This model rank's part of the whole ``t`` under ``rule``."""
    m, i = mesh.model, mesh.model_index
    if rule is None or m == 1:
        return t
    if rule == "row":
        return t.chunk(m, dim=1)[i].contiguous()
    if rule == "qkv":
        return t.reshape((3, m, t.shape[0] // (3 * m)) + tuple(t.shape[1:]))[:, i].reshape(
            (t.shape[0] // m,) + tuple(t.shape[1:])).contiguous()
    return t.chunk(m, dim=0)[i].contiguous()


def gather_tensor(t: torch.Tensor, rule: Optional[str], mesh: Mesh) -> torch.Tensor:
    """The whole tensor from the model ranks' parts (a collective of the
    model group): the inverse of ``shard_tensor``."""
    m = mesh.model
    if rule is None or m == 1:
        return t
    if rule == "row":
        parts = mesh.all_gather(t.t().contiguous(), "model")  # (m * in / m, out)
        return parts.t().contiguous()
    parts = mesh.all_gather(t.contiguous(), "model").reshape((m,) + tuple(t.shape))
    if rule == "qkv":
        parts = parts.reshape((m, 3, t.shape[0] // 3) + tuple(t.shape[1:])).transpose(0, 1)
    return parts.reshape((-1,) + tuple(t.shape[1:])).contiguous()


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: Mesh, cfg) -> Dict[str, torch.Tensor]:
    """A whole model's state dict -> this model rank's (``tp_rule``)."""
    return {k: shard_tensor(v, tp_rule(k, cfg), mesh) for k, v in sd.items()}


def gather_state_dict(sd: Dict[str, torch.Tensor], mesh: Mesh, cfg) -> Dict[str, torch.Tensor]:
    """A model rank's state dict -> the whole model's, on every rank of the
    model group (each rank calls it, in the same key order)."""
    return {k: gather_tensor(v, tp_rule(k, cfg), mesh) for k, v in sd.items()}


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
