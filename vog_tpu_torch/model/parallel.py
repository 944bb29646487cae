"""Tensor parallelism over the mesh's model axis (train/dist.py): the
autograd functions that join a sharded layer to the whole activations
around it, Megatron-LM's conjugate pair and a gather.

  * ``copy_to_model``: identity forward, sum over the model ranks
    backward.  It goes before every column-sharded layer (and before a
    ring block's token slice), whose input gradient is partial on each
    rank.
  * ``reduce_from_model``: sum over the model ranks forward, identity
    backward.  It goes after every row-sharded layer; that layer's bias is
    added once, after the sum (``row_linear``).
  * ``gather_from_model``: the ranks' blocks concatenated along ``dim``
    forward (in model-index order), this rank's block of the gradient
    backward.

Every activation outside a sharded layer is whole and bitwise the same on
every model rank, and so is its gradient, so the pair keeps each sum in
one place.  With no model group each is the identity.  On a gloo group
the collectives stage through the host (``Mesh._staged``), which a CUDA
graph cannot hold.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from vog_tpu_torch.model.dtypes import linear


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone(), "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    parts = mesh.all_gather(x.movedim(dim, 0).contiguous(), "model")  # (m * n, ...)
    return parts.movedim(0, dim).contiguous()


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return _gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.model_index
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


def _on(mesh) -> bool:
    return mesh is not None and mesh.model_group is not None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh) if _on(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh) if _on(mesh) else x


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh, dim % x.dim()) if _on(mesh) else x


def row_linear(x: torch.Tensor, lin: nn.Linear, mesh, dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """A row-sharded ``lin`` (its weight this rank's block of input
    features, its bias whole) on ``x``, this rank's block of features:
    the partial products summed over the model ranks in fp32, then the
    bias, in ``dt`` (default x's dtype).  Without a model group it is
    ``linear``."""
    if not _on(mesh):
        return linear(x, lin, dt)
    dt = x.dtype if dt is None else dt
    part = Fn.linear(x.to(dt), lin.weight.to(dt))
    y = reduce_from_model(part.float(), mesh)
    return (y + lin.bias.float()).to(dt) if dt != torch.float32 else y + lin.bias
