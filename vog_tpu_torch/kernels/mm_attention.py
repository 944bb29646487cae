"""Shared-QK multi-arg attention (decomposed first mm layer), fp32 operands,
forward and backward.

Per arg a:  out_a = softmax_j(s_ij + cn_aj) . vm,
            s = qm.km^T + fb[h, fid_i, fid_j], key-masked to NEG,
with the 1/sqrt(dh) scale folded into qm by the caller and cn the per-arg
log-domain key weighting in its natural (B,H,A,T) layout.

Replaces vog_tpu/kernels/mm_attention.py §_fwd (_fwd_kernel).  CUDA
kernel: csrc/mm_attention.cu (mm_fwd; at "default" mm_fwd_wg, below; past dh 128 mm_fwd_cl).  Bound by operations on the H100
(the A value products dominate), so every product runs on the tensor
cores in 3xTF32 (``mma.sync``, fp32-level accuracy, as the flash kernels):
a block of 4 warps owns 16 query rows and streams 32-key tiles of km, vm
and cn by ``cp.async``; it computes each score tile once for all args into
shared memory, then each warp keeps a per-arg running max and denominator
(each final denominator is >= 1) and the A outputs of its 32 columns in
registers, so neither the (T,T) scores nor the A value streams reach
device memory.  One library call computes the same output:
``scaled_dot_product_attention`` on the query repeated over the A args,
(B, H, A*T, dh), with a float mask fb[h, fid_i, fid_j] + cn[b, h, a, j]
(masked keys at NEG; 51 MB at GT5).  ``chip_smoke.py`` times it as this
kernel's yardstick; the port never calls it.

Backward: replaces §_mm_attn_bwd in both of its modes, chosen per call
(``bwd_mode``) or for the process (``VOG_MM_BWD``) as the TPU package
chooses them (``resolve_bwd_mode``, default "emit").  In both, mm_bwd_delta
forms delta_a = rowsum(g_a * out_a) and mm_bwd_dkv (3xTF32 ``mma.sync``, a
block of 4 warps owns 64 keys and streams 16-row query tiles and each
arg's g_a tile by ``cp.async``) computes each score tile once for all args,
recomputes p_a from the saved per-arg row max and denominator and writes
dk, dv and dcn (csrc/mm_attention.cu).
  * "emit" (``_make_bwd_dkv_kernel(True)``): mm_bwd_dkv also writes the
    summed score gradient comb = sum_a ds_a (B*H, T, T); dq = comb . km and
    the frame-bias gradient (onehot^T comb onehot, summed over b) are plain
    products over it, as the TPU package leaves them to XLA.  The default,
    as in the TPU package: recompute redoes the A g_a.vm products for dq
    (A+1 extra passes over every (i, j)).
  * "recompute" (``_bwd_dkv_noemit_kernel`` + ``_bwd_dq_kernel``): no
    (T, T) buffer; mm_bwd_dq (8 warps, 64 query rows a block, 64-key
    tiles, each arg's g_a rows streamed by ``cp.async``) derives the tiles again
    over query rows (S once a key tile for all args, then each arg's
    g_a.vm^T and ds_a), sums comb on chip, accumulates dq = comb . km and
    the frame sums on the tensor cores, and writes one (F, F) frame-bias
    partial per (b, h, 64 query rows), which the wrapper adds up in a fixed
    order.  For memory: comb is 512 MB at P100 (B=2, T=4000).
Both modes compute the same function; on the CPU both run
``mm_attention_bwd_plain``.

Shapes: every kernel takes dh <= 128 as the DK 128 instance (``HEAD_DIMS``;
a call pads dh up to it) and every dh past 128 on a thread block cluster
(mm_fwd_cl, mm_bwd_dkv_cl, mm_bwd_dq_cl, in the library built with
-DVOG_MM_CLUSTER=1; csrc/cluster.cuh, kernels/_cluster.py): each block of a
tile stages its 128 columns by TMA, each score partial summed once over the
cluster; a dh that is not a multiple of 4 is padded with zero columns
(TMA's 16-byte rows), a tensor that does not start on 16 bytes copied, and
the output and gradients sliced back.  All take any frame count (the (F,
F) table in shared memory up to 64 frames, read from device memory past
that and on the cluster path; the dq kernels sum the frame-bias gradient in
tiles of 64 frames).  A launch takes at most 8 args (``KERNEL_ARGS``; past
dh 128 ``cluster_plan``'s: the forward 7, 4 past dh 1024, the backward 8;
``fwd_groups``, ``bwd_groups``); more run in groups (``arg_groups``:
9 -> 5 + 4), each group's launches counted under the kernel's name: the forward's outputs
are concatenated over A (each arg depends on the shared scores and its
own cn_a alone), and the groups' gradients added up in group order
(``sum_arg_groups``).  ``mm_shared_qk_attention`` is a
``torch.autograd.Function`` whose ctx carries the mode from the forward to
the backward.  ``key_mask`` and ``frame_ids`` get no gradient.

Precision (``config.kernel_precision``), as ``kernels/attention.py``: at
"highest" 3xTF32 products; at "default" one TF32 pass (the library built
with ``-DVOG_ONE_PASS=1``), launches counted as
``mm_shared_qk_attention@default`` and so on, and emit mode stores comb
in bf16, as the TPU package does at "default" on the chip (its
mm_attention.py:413-427), widened to fp32 for the two products over it
(``_build.bmm_wide``).  The production recipe's backward (emit at
"default", dh <= 128) is its own kernel, mm_bwd_dkv_wg (``bwd_route``
"wg"): Hopper's wgmma, a block of two consumer warpgroups of 64 keys and
a producer warpgroup streaming 32-row query tiles (csrc/mm_attention.cu),
its launches counted under ``mm_bwd_dkv_wg@default`` beside
``mm_shared_qk_attention_bwd@default``; so is its forward at every
one-pass precision name, dh <= 128 (``fwd_route`` "wg"): mm_fwd_wg, a
block of 64 query rows, two consumer warpgroups of 64 head-dim columns
each on wgmma (O_a^T += V^T P_a^T) and a producer warpgroup streaming
32-key K and V tiles, at most WG_FWD_ARGS args a launch, counted under
``mm_fwd_wg@default`` beside ``mm_shared_qk_attention@default``; the
one-pass narrow library holds no mm_fwd.  The forward reads the precision and its ctx
carries it to the backward; the plain versions take ``precision`` for the
wrappers' signature only.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from vog_tpu_torch.config.defaults import PRECISIONS, kernel_precision
from vog_tpu_torch.kernels import _build
from vog_tpu_torch.kernels._cluster import ROW_ALIGN, SLICE, arg_groups, cluster_args, cluster_plan, pad_cols

NEG = -1e30
NAME = "mm_shared_qk_attention"
NAME_BWD = "mm_shared_qk_attention_bwd"  # emit mode
NAME_BWD_RECOMPUTE = "mm_shared_qk_attention_bwd_recompute"
# the emit backward's dk/dv/dcn kernel at "default" and dh <= 128 (``bwd_route``
# "wg"), counted beside NAME_BWD where it launches
NAME_WG = "mm_bwd_dkv_wg"
# the forward's kernel at a one-pass precision and dh <= 128 (``fwd_route``
# "wg"), counted beside NAME where it launches
NAME_FWD_WG = "mm_fwd_wg"
KERNEL_ARGS = 8  # args a launch takes (template cases 1..8 in csrc/mm_attention.cu)
WG_FWD_ARGS = 5  # args a launch of mm_fwd_wg takes (kFwArgs: its accumulators, 32 registers an arg)
# the kernels' head-dim instance (its own library): a call pads dh up to
# it, and past it takes the cluster instances (kernels/_cluster.py) of the
# other library (built with -DVOG_MM_CLUSTER=1)
HEAD_DIMS = (128,)
DQ_ROWS = 64  # query rows a block of the dq kernels owns (kDqRows, kClDqRows in csrc/mm_attention.cu)


def head_dim_instance(dh: int) -> Tuple[int, int]:
    """(the columns a block of the kernels that take a head dim of ``dh``
    stages, the blocks a tile of rows has): 128 and one block, or past 128
    a 128-column slice a block and ``cluster_plan``'s cluster."""
    return (HEAD_DIMS[0], 1) if dh <= HEAD_DIMS[0] else (SLICE, cluster_plan(dh).cluster)


def _part(dh: int):
    """``_build.function``'s ``part`` of the library that takes a head dim
    of ``dh``: None (the DK 128 instances), or past 128 the cluster
    instances' (``_build.CLUSTER``)."""
    return None if dh <= HEAD_DIMS[0] else _build.CLUSTER


def fwd_route(precision: str, dh: int) -> str:
    """The forward's kernel for a call at ``precision`` (any name
    ``PRECISIONS`` takes) and head dim ``dh``, at any frame count and arg
    count: "cluster" past dh 128 (mm_fwd_cl); "wg" at a one-pass precision,
    the production recipe's (mm_fwd_wg: wgmma, a producer warpgroup; the
    library part ``_build.WG``); else "narrow" (mm_fwd, 3xTF32)."""
    if dh > HEAD_DIMS[0]:
        return "cluster"
    return "wg" if PRECISIONS.get(precision, precision) == "default" else "narrow"


def bwd_route(mode: str, precision: str, dh: int) -> str:
    """The backward's kernels for a call in ``mode`` at ``precision`` and
    head dim ``dh``, at any frame count and arg count (each group of
    ``bwd_groups`` takes the same route): "cluster" past dh 128
    (mm_bwd_dkv_cl, and mm_bwd_dq_cl in recompute mode); "wg" in emit mode
    at "default", the production recipe's (mm_bwd_dkv_wg: wgmma, a producer
    warpgroup; the library part ``_build.WG``); else "narrow" (mm_bwd_dkv,
    and mm_bwd_dq in recompute mode): every "highest" call and recompute
    mode."""
    if dh > HEAD_DIMS[0]:
        return "cluster"
    return "wg" if mode == "emit" and precision == "default" else "narrow"


# mm_bwd_dkv_wg's shared tiles (csrc/mm_attention.cu §cm_idx): K-major core
# matrices, element (row r, column c) at (c / 4) ld + 4 r + c % 4, where ld
# is the floats between two 4-column groups: the K / V rows of a
# warpgroup's 64 keys (WG_KV_LD), a Q tile (WG_Q_LD) and a g_a tile
# (WG_G_LD) of 32 query rows, and the staging tile of P_a^T or comb^T (rows
# the 64 keys, columns the 32 query rows: WG_P_LD); a g_a and a staging
# tile carry 16 floats of padding a group (conflict-free fragment traffic)
WG_KEYS, WG_ROWS = 64, 32
WG_KV_LD, WG_Q_LD, WG_G_LD, WG_P_LD = 4 * WG_KEYS, 4 * WG_ROWS, 4 * WG_ROWS + 16, 4 * WG_KEYS + 16


def wg_tile_index(r: int, c: int, ld: int) -> int:
    """Mirror of ``cm_idx``: the float of (row r, column c) in a tile of
    group stride ``ld``."""
    return (c // 4) * ld + 4 * r + c % 4


def wg_d_of_m(m: int) -> int:
    """The head-dim column d of row m (0 <= m < 128, two 64-row halves) of
    mm_bwd_dkv_wg's transposed products dV^T and dK^T: row 16 w + g of a
    half is d = 16 w + 2 g and row 16 w + g + 8 is d + 1, so that the two
    rows of a lane's A fragment (g and g + 8) are one float2 of a g_a or Q
    tile; the kernel writes dV[key, d] and dK[key, d] from row m."""
    h, x = divmod(m, 64)
    w, y = divmod(x, 16)
    return 64 * h + 16 * w + 2 * (y % 8) + y // 8


# mm_fwd_wg's shared tiles, in the same core-matrix layout (``wg_tile_index``):
# the resident Q rows of a 64-row block (FW_Q_LD, wgmma's A of S), a K tile
# and a V tile of 32 keys (FW_K_LD, the B operand of S; FW_V_LD, read as
# the A fragments of V^T, in ``wg_d_of_m``'s head-dim order, padded 16
# floats a group), and the staging tile of P_a (rows the 64 query rows,
# columns the tile's 32 keys: FW_P_LD, padded), the B operand of O_a^T
FW_ROWS, FW_KEYS = 64, 32
FW_Q_LD, FW_K_LD, FW_V_LD, FW_P_LD = 4 * FW_ROWS, 4 * FW_KEYS, 4 * FW_KEYS + 16, 4 * FW_ROWS + 16


def fw_pos(q: int) -> int:
    """Mirror of ``fw_pos``: where mm_fwd_wg keeps query row q's (0..63)
    rescale factor or row sum in a 64-float vector, so that the 16 query
    columns q = 8 n + 2 t + e of a lane t of an O^T C fragment are the 16
    floats from 16 t on."""
    return 16 * ((q >> 1) & 3) + 2 * (q >> 3) + (q & 1)


def fwd_groups(A: int, dh: int, precision: str):
    """The forward's launches at ``precision``, [(a0, a1), ...]: on the
    "wg" route (``fwd_route``) ``arg_groups`` of WG_FWD_ARGS, on the narrow
    one of KERNEL_ARGS, past dh 128 the cluster plan's (7 args a launch, 4
    past dh 1024: kernels/_cluster.py)."""
    route = fwd_route(precision, dh)
    if route == "cluster":
        return list(cluster_plan(dh, A).groups)
    return arg_groups(A, WG_FWD_ARGS if route == "wg" else KERNEL_ARGS)


def bwd_groups(A: int, dh: int):
    """The backward's launches, [(a0, a1), ...]: ``arg_groups`` of
    KERNEL_ARGS, past dh 128 the cluster plan's (8 args a launch)."""
    return list(cluster_plan(dh, A).bwd_groups) if dh > HEAD_DIMS[0] else arg_groups(A, KERNEL_ARGS)


def _args(t: torch.Tensor, a0: int, a1: int) -> torch.Tensor:
    """Args a0..a1 - 1 of a (B, H, A, ...) tensor, contiguous."""
    return t[:, :, a0:a1].contiguous()


def fwd_by_groups(fwd, qm, km, vm, cn, *rest):
    """``fwd`` (the narrow or cluster kernel's launch, or the plain
    version) once for each of those routes' ``fwd_groups``, on its args of
    ``cn``, -> its outputs concatenated over A.  Exact: each arg's output
    depends on the shared scores and its own cn_a alone."""
    groups = fwd_groups(cn.shape[2], qm.shape[-1], "highest")  # no precision changes these routes' groups
    if len(groups) == 1:
        return fwd(qm, km, vm, cn, *rest)
    parts = [fwd(qm, km, vm, _args(cn, a0, a1), *rest) for a0, a1 in groups]
    return tuple(torch.cat(x, dim=2) for x in zip(*parts))


def sum_arg_groups(parts):
    """The groups' gradients [(dq, dk, dv, dcn, dfb), ...], in group
    order -> one (dq, dk, dv, dcn, dfb): dq, dk, dv and dfb summed group by
    group in order (a fixed order: the same sums on every run), dcn
    concatenated over A."""
    out = list(parts[0])
    for p in parts[1:]:
        for i in (0, 1, 2, 4):
            out[i] = out[i] + p[i]
    out[3] = torch.cat([p[3] for p in parts], dim=2)
    return tuple(out)


def bwd_by_groups(bwd, qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den, g, *rest):
    """``bwd`` (a kernel's launches, or the plain version) once for each
    of ``arg_groups``, on its args of cn, out, the row max, the denominator
    and g, -> the groups' gradients added up by ``sum_arg_groups``."""
    groups = bwd_groups(cn.shape[2], qm.shape[-1])
    if len(groups) == 1:
        return bwd(qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den, g, *rest)
    return sum_arg_groups([
        bwd(qm, km, vm, _args(cn, a0, a1), key_mask, frame_bias, frame_ids, _args(out, a0, a1),
            _args(mrow, a0, a1), _args(den, a0, a1), _args(g, a0, a1), *rest)
        for a0, a1 in groups])


def resolve_bwd_mode(mode: Optional[str]) -> str:
    """The backward's mode, as the TPU package's ``_resolve_mm_bwd_mode``
    picks it: None or "auto" reads ``VOG_MM_BWD``, whose "auto" (or
    absence) means "emit"; anything but "emit" and "recompute" raises."""
    if mode is None or mode == "auto":
        mode = os.environ.get("VOG_MM_BWD", "auto")
    if mode == "auto":
        mode = "emit"
    if mode not in ("emit", "recompute"):
        raise ValueError(f"bad mm bwd_mode {mode!r}")
    return mode


def mm_attention_plain(qm, km, vm, cn, key_mask, frame_bias, frame_ids, precision=None):
    """Plain PyTorch version -> (out (B,H,A,T,dh), row max (B,H,A,T),
    denominator (B,H,A,T))."""
    fid = frame_ids.long()
    shared = torch.matmul(qm, km.transpose(-1, -2)) + frame_bias.float()[:, fid][:, :, fid][None]
    shared = torch.where(key_mask[:, None, None, :] > 0, shared, torch.full_like(shared, NEG))
    t = shared[:, :, None] + cn[:, :, :, None, :]  # (B,H,A,T,T)
    m = t.amax(dim=-1, keepdim=True)
    p = torch.exp(t - m)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vm[:, :, None]) / den
    return out, m[..., 0], den[..., 0]


def _check_cuda(qm, km, vm, cn, key_mask, frame_bias, frame_ids):
    if qm.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {qm.device}")
    dev = qm.device
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    Fn = frame_bias.shape[-1]
    if A < 1:
        raise ValueError(f"{NAME}: no args (A={A})")
    for name, t in (("qm", qm), ("km", km), ("vm", vm)):
        _build.require(t, name, torch.float32, 4, dev)
        if tuple(t.shape) != (B, H, T, dh):
            raise ValueError(f"{NAME}: {name} shape {tuple(t.shape)} != qm shape")
    _build.require(cn, "cn", torch.float32, 4, dev)
    _build.require(key_mask, "key_mask", torch.float32, 2, dev)
    _build.require(frame_bias, "frame_bias", torch.float32, 3, dev)
    _build.require(frame_ids, "frame_ids", torch.int32, 1, dev)
    if tuple(cn.shape) != (B, H, A, T) or tuple(key_mask.shape) != (B, T):
        raise ValueError(f"{NAME}: cn/key_mask shapes do not match qm")
    if tuple(frame_bias.shape) != (H, Fn, Fn) or frame_ids.shape[0] != T:
        raise ValueError(f"{NAME}: frame_bias/frame_ids shapes do not match qm")


def _mm_fwd_cuda(qm, km, vm, cn, key_mask, frame_bias, frame_ids, prec):
    """The forward kernel's launches (the op's CUDA implementation), one
    a group of args (``fwd_by_groups``)."""
    _check_cuda(qm, km, vm, cn, key_mask, frame_bias, frame_ids)
    if fwd_route(prec, qm.shape[-1]) == "wg":
        return _mm_fwd_wg_launch(qm, km, vm, cn, key_mask, frame_bias, frame_ids)
    return fwd_by_groups(_mm_fwd_launch, qm, km, vm, cn, key_mask, frame_bias, frame_ids, prec)


def _mm_fwd_launch(qm, km, vm, cn, key_mask, frame_bias, frame_ids, prec):
    """One launch of the forward kernel, at most ``fwd_groups``' args: dh
    <= 128 in the DK 128 library, past it the cluster instance (the other
    library) on qm, km, vm padded with zero columns to a multiple of 4 and
    starting on 16 bytes (``pad_cols``), as clusters of the plan's size."""
    dev = qm.device
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    Fn = frame_bias.shape[-1]
    dk, n, (qm, km, vm) = cluster_args(dh, qm, km, vm)  # past 128: cluster_plan's head dim and cluster
    out = torch.empty((B, H, A, T, dk), dtype=torch.float32, device=dev)
    mrow = torch.empty((B, H, A, T), dtype=torch.float32, device=dev)
    den = torch.empty((B, H, A, T), dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("mm_attention.cu", "vog_mm_fwd", [P] * 10 + [I] * 7 + [P], prec, _part(dh))
    rc = fn(dev.index, qm.data_ptr(), km.data_ptr(), vm.data_ptr(), cn.data_ptr(),
            key_mask.data_ptr(), frame_bias.data_ptr(), frame_ids.data_ptr(),
            out.data_ptr(), mrow.data_ptr(), den.data_ptr(),
            B, H, A, T, dk, Fn, n, _build.stream_ptr(qm))
    _build.check(rc, NAME)
    _build.count(NAME, prec)
    return (out if dk == dh else out[..., :dh].contiguous()), mrow, den


def _mm_fwd_wg_launch(qm, km, vm, cn, key_mask, frame_bias, frame_ids):
    """The "wg" route (``fwd_route``): mm_fwd_prep_wg (once) and mm_fwd_wg
    (the library part ``_build.WG``), a launch a group of ``fwd_groups``
    (at most WG_FWD_ARGS args), each writing its args in place into the
    outputs of every arg (no copy of cn or of the outputs); qm, km and vm
    padded with zero columns to a multiple of 4 and starting on 16 bytes
    (``pad_cols``: the kernel copies 16-byte row pieces), the output sliced
    back -> (out, row max, den)."""
    dev = qm.device
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    Fn = frame_bias.shape[-1]
    kd = -(-dh // ROW_ALIGN) * ROW_ALIGN
    qm, km, vm = (pad_cols(t, kd) for t in (qm, km, vm))
    kr = torch.empty_like(km)  # scratch: km rounded to TF32, written by the kernels
    out = torch.empty((B, H, A, T, kd), dtype=torch.float32, device=dev)
    mrow = torch.empty((B, H, A, T), dtype=torch.float32, device=dev)
    den = torch.empty((B, H, A, T), dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("mm_attention.cu", "vog_mm_fwd_wg", [P] * 11 + [I] * 8 + [P], "default", _build.WG)
    for a0, a1 in fwd_groups(A, dh, "default"):
        rc = fn(dev.index, qm.data_ptr(), km.data_ptr(), vm.data_ptr(), cn.data_ptr(), key_mask.data_ptr(),
                frame_bias.data_ptr(), frame_ids.data_ptr(), kr.data_ptr(), out.data_ptr(), mrow.data_ptr(),
                den.data_ptr(), B, H, a1 - a0, T, kd, Fn, A, a0, _build.stream_ptr(qm))
        _build.check(rc, NAME_FWD_WG)
        _build.count(NAME, "default")
        _build.count(NAME_FWD_WG, "default")
    return (out if kd == dh else out[..., :dh].contiguous()), mrow, den


def _mm_fwd_fake(qm, km, vm, cn, key_mask, frame_bias, frame_ids, precision):
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    return qm.new_empty((B, H, A, T, dh)), qm.new_empty((B, H, A, T)), qm.new_empty((B, H, A, T))


# the op ``vog::mm_attention_fwd`` (``_build.define_op``)
_build.define_op(
    "mm_attention_fwd(Tensor qm, Tensor km, Tensor vm, Tensor cn, Tensor key_mask, Tensor frame_bias, "
    "Tensor frame_ids, str precision) -> (Tensor, Tensor, Tensor)",
    cuda=_mm_fwd_cuda, cpu=mm_attention_plain, fake=_mm_fwd_fake)


def mm_attention_fwd(
    qm: torch.Tensor,
    km: torch.Tensor,
    vm: torch.Tensor,
    cn: torch.Tensor,
    key_mask: torch.Tensor,
    frame_bias: torch.Tensor,
    frame_ids: torch.Tensor,
    precision: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qm,km,vm (B,H,T,dh) fp32; cn (B,H,A,T); key_mask (B,T) fp32;
    frame_bias (H,F,F); frame_ids (T,) int32 -> (out, row max, den), at
    ``precision`` (None: ``kernel_precision()``), through the op
    ``vog::mm_attention_fwd``."""
    if qm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: unsupported device {qm.device}")
    return torch.ops.vog.mm_attention_fwd(qm, km, vm, cn, key_mask, frame_bias, frame_ids,
                                          precision or kernel_precision())


def _dq_dfb(comb, km, frame_ids, Fn, H):
    """dq = comb . km and dfb = sum_b onehot^T comb onehot (H,F,F), in fp32
    (a bf16 comb widened: ``_build.bmm_wide``)."""
    BH, T, _ = comb.shape
    dq = _build.bmm_wide(comb, km.reshape(BH, T, -1))
    onehot = torch.nn.functional.one_hot(frame_ids.long(), Fn).float()  # (T,F)
    if comb.dtype == torch.float32:
        dfb = torch.matmul(torch.matmul(onehot.t(), comb), onehot)  # (BH,F,F)
    else:
        dfb = torch.matmul(onehot.t(), _build.bmm_wide(comb, onehot))
    return dq.reshape(km.shape), dfb.reshape(-1, H, Fn, Fn).sum(0)


def mm_attention_bwd_plain(qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den, g,
                           bwd_mode=None, precision=None):
    """Plain PyTorch backward from the saved per-arg row max and
    denominator -> (dq, dk, dv, dcn, dfb), as ``_make_bwd_dkv_kernel``
    defines it: p_a = exp(s + cn_a - m_a), ds_a = p_a (g_a.vm - delta_a) /
    den_a, comb = sum_a ds_a masked to the valid keys, dcn_a = sum_i ds_a.
    Both modes compute this function; ``bwd_mode`` and ``precision`` are
    taken for the kernel wrapper's signature and do not change the
    arithmetic."""
    B, H, T, dh = qm.shape
    Fn = frame_bias.shape[-1]
    fid = frame_ids.long()
    valid = key_mask[:, None, None, :] > 0
    s = torch.matmul(qm, km.transpose(-1, -2)) + frame_bias.float()[:, fid][:, :, fid][None]
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.exp(s[:, :, None] + cn[:, :, :, None, :] - mrow[..., None])  # (B,H,A,T,T)
    delta = (g * out).sum(-1)  # (B,H,A,T)
    gv = torch.matmul(g, vm[:, :, None].transpose(-1, -2))  # (B,H,A,T,T)
    ds = p * (gv - delta[..., None]) / den[..., None]
    dcn = ds.sum(-2)
    comb = torch.where(valid, ds.sum(2), torch.zeros_like(s))  # (B,H,T,T)
    dv = torch.matmul((p / den[..., None]).transpose(-1, -2), g).sum(2)
    dk = torch.matmul(comb.transpose(-1, -2), qm)
    dq, dfb = _dq_dfb(comb.reshape(B * H, T, T), km, frame_ids, Fn, H)
    return dq, dk, dv, dcn, dfb


def mm_attention_bwd(qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den, g,
                     bwd_mode=None, precision=None):
    """Backward of ``mm_attention_fwd`` -> (dq, dk, dv, dcn, dfb): on the
    card the CUDA kernels of ``bwd_mode`` (``resolve_bwd_mode``) at
    ``precision`` (None: ``kernel_precision()``), in emit mode with two
    products over their comb (bf16 at "default"); the plain version on the
    CPU."""
    mode = resolve_bwd_mode(bwd_mode)
    prec = precision or kernel_precision()
    if qm.device.type == "cpu":
        return mm_attention_bwd_plain(qm, km, vm, cn, key_mask, frame_bias, frame_ids,
                                      out, mrow, den, g)
    _check_cuda(qm, km, vm, cn, key_mask, frame_bias, frame_ids)
    return bwd_by_groups(_mm_bwd_launch, qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den, g,
                         mode, prec)


def _mm_bwd_launch(qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den, g, mode, prec):
    """The backward kernels of ``mode`` for one group of args (at most
    KERNEL_ARGS; past dh 128 the cluster instances, ``cluster_plan``'s
    groups, on qm, km, vm, out and g padded with zero columns to a
    multiple of 4 and starting on 16 bytes, as clusters of the plan's
    size, the gradients sliced back) -> (dq, dk, dv, dcn, dfb)."""
    dev = qm.device
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    Fn = frame_bias.shape[-1]
    _build.require(g, "g", torch.float32, 5, dev)
    if g.shape != out.shape or tuple(g.shape) != (B, H, A, T, dh):
        raise ValueError(f"{NAME_BWD}: g shape {tuple(g.shape)} != out shape")
    for name, t in (("mrow", mrow), ("den", den)):
        _build.require(t, name, torch.float32, 4, dev)
    _build.require(out, "out", torch.float32, 5, dev)
    if bwd_route(mode, prec, dh) == "wg":
        return _mm_bwd_wg_launch(qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den, g)
    kd, n, (qm, km, vm, out, g) = cluster_args(dh, qm, km, vm, out, g)  # past 128: cluster_plan's
    delta = torch.empty_like(cn)  # (B,H,A,T) rowsum(g * out), written by the kernel
    dk, dv = torch.empty_like(km), torch.empty_like(vm)
    dcn = torch.empty_like(cn)
    if mode == "emit":
        comb = torch.empty((B * H, T, T), dtype=torch.float32 if prec == "highest" else torch.bfloat16,
                           device=dev)
        dq = part = None
    else:  # no (T, T) buffer: dq and the frame-bias partials from mm_bwd_dq
        comb = None
        dq = torch.empty_like(qm)
        part = torch.empty((B, H, -(-T // DQ_ROWS), Fn, Fn), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    P, I = _build.P, _build.I
    fn = _build.function("mm_attention.cu", "vog_mm_bwd", [P] * 18 + [I] * 7 + [P], prec, _part(dh))
    rc = fn(dev.index, qm.data_ptr(), km.data_ptr(), vm.data_ptr(), cn.data_ptr(),
            key_mask.data_ptr(), frame_bias.data_ptr(), frame_ids.data_ptr(), g.data_ptr(), out.data_ptr(),
            mrow.data_ptr(), den.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dcn.data_ptr(), ptr(comb), ptr(dq), ptr(part), B, H, A, T, kd, Fn, n,
            _build.stream_ptr(qm))
    if kd != dh:
        dk, dv = dk[..., :dh].contiguous(), dv[..., :dh].contiguous()
        dq = None if dq is None else dq[..., :dh].contiguous()
    if mode == "emit":  # "highest" (at "default" dh <= 128 is the "wg" route's)
        _build.check(rc, NAME_BWD)
        _build.count(NAME_BWD, prec)
        dq, dfb = _dq_dfb(comb, km[..., :dh], frame_ids, Fn, H)
    else:
        _build.check(rc, NAME_BWD_RECOMPUTE)
        _build.count(NAME_BWD_RECOMPUTE, prec)
        dfb = part.sum(dim=(0, 2))
    return dq, dk, dv, dcn, dfb


def _mm_bwd_wg_launch(qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den, g):
    """The "wg" route (``bwd_route``) for one group of at most KERNEL_ARGS
    args: mm_bwd_prep_wg and mm_bwd_dkv_wg (the library part ``_build.WG``),
    comb in bf16, then dq and dfb over it; qm, km, vm, out and g padded with
    zero columns to a multiple of 4 and starting on 16 bytes (``pad_cols``:
    the kernel copies 16-byte row pieces) -> (dq, dk, dv, dcn, dfb)."""
    dev = qm.device
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    Fn = frame_bias.shape[-1]
    kd = -(-dh // ROW_ALIGN) * ROW_ALIGN
    qm, km, vm, out, g = (pad_cols(t, kd) for t in (qm, km, vm, out, g))
    # scratch, written by the kernels: delta = rowsum(g * out), 1 / den, g and
    # qm rounded to TF32 (the operands mm_bwd_dkv_wg's producer copies)
    delta, inv = torch.empty_like(cn), torch.empty_like(cn)
    gr, qr = torch.empty_like(g), torch.empty_like(qm)
    dk, dv = torch.empty_like(km), torch.empty_like(vm)
    dcn = torch.empty_like(cn)
    comb = torch.empty((B * H, T, T), dtype=torch.bfloat16, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("mm_attention.cu", "vog_mm_bwd_wg", [P] * 19 + [I] * 6 + [P], "default", _build.WG)
    rc = fn(dev.index, qm.data_ptr(), km.data_ptr(), vm.data_ptr(), cn.data_ptr(), key_mask.data_ptr(),
            frame_bias.data_ptr(), frame_ids.data_ptr(), g.data_ptr(), out.data_ptr(), mrow.data_ptr(),
            den.data_ptr(), delta.data_ptr(), gr.data_ptr(), qr.data_ptr(), inv.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dcn.data_ptr(), comb.data_ptr(), B, H, A, T, kd, Fn, _build.stream_ptr(qm))
    _build.check(rc, NAME_WG)
    _build.count(NAME_BWD, "default")
    _build.count(NAME_WG, "default")
    if kd != dh:
        dk, dv = dk[..., :dh].contiguous(), dv[..., :dh].contiguous()
    dq, dfb = _dq_dfb(comb, km[..., :dh], frame_ids, Fn, H)
    return dq, dk, dv, dcn, dfb


class MMSharedQKAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qm, km, vm, cn, key_mask, frame_bias, frame_ids, bwd_mode):
        ctx.precision = kernel_precision()
        out, mrow, den = mm_attention_fwd(qm, km, vm, cn, key_mask, frame_bias, frame_ids,
                                          ctx.precision)
        ctx.bwd_mode = bwd_mode
        ctx.save_for_backward(qm, km, vm, cn, key_mask, frame_bias, frame_ids, out, mrow, den)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv, dcn, dfb = mm_attention_bwd(*ctx.saved_tensors, g.contiguous(),
                                                bwd_mode=ctx.bwd_mode, precision=ctx.precision)
        name = NAME_BWD_RECOMPUTE if ctx.bwd_mode == "recompute" else NAME_BWD
        _build.check_outputs(name, dq, dk, dv, dcn, dfb)
        return dq, dk, dv, dcn, None, dfb, None, None


def mm_shared_qk_attention(qm, km, vm, cn, key_mask, frame_bias, frame_ids,
                           bwd_mode: Optional[str] = None) -> torch.Tensor:
    """-> (B,H,A,T,dh), the JAX package's signature, with its gradient
    (``MMSharedQKAttention``) where an input requires one (else the forward
    op alone); ``bwd_mode`` ("emit", "recompute", "auto" or
    None) is resolved here, at the call, as the TPU package resolves it."""
    mode = resolve_bwd_mode(bwd_mode)
    if not _build.needs_grad(qm, km, vm, cn, frame_bias):  # inference, an export: the op alone
        return mm_attention_fwd(qm, km, vm, cn, key_mask, frame_bias, frame_ids)[0]
    return MMSharedQKAttention.apply(qm, km, vm, cn, key_mask, frame_bias, frame_ids, mode)
