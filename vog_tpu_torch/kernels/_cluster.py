"""The launch plan of the attention kernels past head dim 128, on a thread
block cluster (``csrc/cluster.cuh``): ``flash_fwd_cl``, ``flash_bwd_dkv_cl``
/ ``flash_bwd_dq_cl`` (the flash kernels), ``mm_fwd_cl`` and
``mm_bwd_dkv_cl`` / ``mm_bwd_dq_cl`` (the mm kernels): every attention
kernel at every head dim past 128, in one design.

A head dim dh > 128 is cut into ceil(dh / 128) column slices; up to
``MAX_CLUSTER`` of them are the blocks of one cluster, each staging and
accumulating its 128 columns, the scores summed once over the cluster.
Past 8 slices (dh > 1024) a block owns several, one a pass (a launch).
``cluster_plan`` is the one place that decides the split: the wrappers
pass its cluster size to the C entries, which launch ceil(slices /
cluster) passes of it.  TMA copies rows of 16 bytes from 16-byte-aligned
addresses, so the wrappers pad a dh that is not a multiple of 4 with zero
columns, and copy a tensor that does not start on 16 bytes (``pad_cols``):
a zero column changes no score and no output column that is kept.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

SLICE = 128  # columns a block stages and accumulates (kSlice)
MAX_CLUSTER = 8  # the portable cluster size (kMaxCluster)
ROW_ALIGN = 4  # floats of 16 bytes: a TMA row stride is a multiple of it
# args a launch of mm_fwd_cl takes (kClArgs: at 8 its accumulators spill),
# and past 8 slices (kClXArgs: the instances that add a block's other
# slices, for the library's build time)
FWD_KERNEL_ARGS = 7
FWD_KERNEL_ARGS_X = 4
# ... of mm_bwd_dkv_cl and mm_bwd_dq_cl at any passes (kClBwdArgs: a warp's
# accumulators do not grow with A, only dcn's two a lane an arg, and every
# launch redoes S)
BWD_KERNEL_ARGS = 8


class ClusterPlan(NamedTuple):
    dh: int  # the head dim asked for
    dh_pad: int  # the head dim the kernels get: dh padded with zero columns to a multiple of 4
    slices: int  # 128-column slices of dh_pad
    passes: int  # launches, each a block's slice z + cluster * pass
    cluster: int  # blocks of a cluster (grid.z)
    cols: int  # columns a block stages and accumulates
    groups: Tuple[Tuple[int, int], ...]  # the mm forward's launches: args [a0, a1), in order
    bwd_groups: Tuple[Tuple[int, int], ...]  # the mm backward's launches: args [a0, a1), in order


def arg_groups(A: int, most: int = 8):
    """[(a0, a1), ...]: A args in ceil(A / most) groups of at most
    ``most`` (a launch's args), as even as possible, the larger first (9 ->
    5 + 4, 10 -> 5 + 5), in order: one launch of each kernel a group."""
    n = -(-A // most)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + A // n + (i < A % n))
    return list(zip(bounds[:-1], bounds[1:]))


def cluster_plan(dh: int, A: int = 1) -> ClusterPlan:
    """The cluster kernels' launches at head dim ``dh`` (> 128) and, for
    the mm kernels, ``A`` args."""
    if dh <= SLICE:
        raise ValueError(f"head dim {dh}: the cluster kernels take dh > {SLICE}")
    dh_pad = -(-dh // ROW_ALIGN) * ROW_ALIGN
    slices = -(-dh_pad // SLICE)
    passes = -(-slices // MAX_CLUSTER)
    fwd = FWD_KERNEL_ARGS if passes == 1 else FWD_KERNEL_ARGS_X
    return ClusterPlan(dh=dh, dh_pad=dh_pad, slices=slices, passes=passes, cluster=-(-slices // passes),
                       cols=SLICE, groups=tuple(arg_groups(A, fwd)),
                       bwd_groups=tuple(arg_groups(A, BWD_KERNEL_ARGS)))


def cluster_args(dh: int, *ts: torch.Tensor):
    """(the kernels' head dim, the cluster size, ``ts``) for a call at head
    dim ``dh``: ``(dh, 1, ts)`` up to SLICE (the narrow instances), past it
    ``cluster_plan``'s padded head dim and cluster, each of ``ts`` through
    ``pad_cols``."""
    if dh <= SLICE:
        return dh, 1, ts
    plan = cluster_plan(dh)
    return plan.dh_pad, plan.cluster, tuple(pad_cols(t, plan.dh_pad) for t in ts)


def pad_cols(t: torch.Tensor, dh_pad: int) -> torch.Tensor:
    """``t`` (..., dh), contiguous, with zero columns up to ``dh_pad``, at
    a 16-byte-aligned address: ``t`` itself when it already is (a view
    that starts past its storage's first float may not be)."""
    dh = t.shape[-1]
    if dh == dh_pad and t.data_ptr() % 16 == 0:
        return t
    return torch.nn.functional.pad(t, (0, dh_pad - dh)).contiguous() if dh < dh_pad else t.clone()
