"""Attention with a factored relative-frame bias, fp32 operands, forward and
backward.

  o = softmax_j(q_i.k_j / sqrt(dh) + fb[h, fid_i, fid_j], key-masked) . v

Forward: replaces vog_tpu/kernels/attention.py §_fwd_call (_fwd_kernel,
_bias_block).  CUDA kernel: csrc/attention.cu.  On the H100 it is bound by
operations at GT5 shapes; the kernel runs its products on the tensor cores
in 3xTF32 (fp32-level accuracy) and an online softmax over 32-key tiles
that stream in by cp.async (the TPU kernel's whole-key-axis block does not
fit 227 KB of shared memory at T=4000), and reads the bias from the head's
(F, F) table in shared memory instead of the TPU kernel's one-hot matmul.
Masked keys take the finite ``NEG`` so a row with every key masked stays
finite.  Forward and backward take dh 64 and 128 as instances
(``HEAD_DIMS``; a call pads dh up to the next one), and every dh past 128
on a thread block cluster (csrc/cluster.cuh, kernels/_cluster.py;
``head_dim_instance``): ceil(dh / 128) blocks a tile of rows, each staging
its 128 columns by TMA, the score partials summed once over the cluster;
a dh that is not a multiple of 4 is padded with zero columns (TMA's
16-byte rows), a tensor that does not start on 16 bytes copied, and the
output and gradients sliced back.  The kernels take any frame count: the
(F, F) table sits in shared memory up to 64 frames and is read from device
memory past that (and on the cluster path), and the dq kernels sum the
frame-bias gradient in tiles of 64 frames.

Backward: replaces §_flash_bwd in both of its modes, chosen per call
(``bwd_mode``) or for the process (``VOG_FLASH_BWD``) as the TPU package
chooses them (``resolve_bwd_mode``, default "recompute").  Both recompute
p = exp(s - lse) from the forward's saved LSE (``_block_tile``) in a dk/dv
kernel over key tiles (flash_bwd_dkv).
  * "recompute" (``_make_bwd_dkv_kernel(False)`` + ``_bwd_dq_kernel``): a
    dq + frame-bias-grad kernel over query tiles (flash_bwd_dq) derives the
    tiles again, so no (T, T) tensor reaches device memory.  The
    frame-bias gradient is one (F, F) partial per (b, h, query tile),
    added up here in a fixed order.
  * "emit" (``_make_bwd_dkv_kernel(True)``): flash_bwd_dkv also writes the
    masked score gradient ds (B*H, T, T); dq = scale * ds . k and the
    frame-bias gradient (onehot^T ds onehot, summed over b) are then plain
    products here, as the TPU package leaves them to XLA (512 MB at P100,
    B=2, T=4000).
With a single frame (F == 1, also the no-bias case) the frame-bias
gradient is sum_ij ds_ij, zero up to rounding, and both modes return
zeros.  ``flash_attention`` is a ``torch.autograd.Function`` whose ctx
carries the mode from the forward to the backward: the CUDA kernels on
the card, ``flash_attention_plain`` / ``flash_attention_bwd_plain`` (the
same function in both modes) on the CPU.  ``key_mask`` and ``frame_ids``
get no gradient.

Precision (``config.kernel_precision``, the counterpart of the TPU
package's ``_precision``): at "highest" the kernels' products are 3xTF32;
at "default" they run one TF32 pass (the library built with
``-DVOG_ONE_PASS=1``, ``csrc/tf32.cuh``), count their launches as
``flash_attention@default`` and so on, and emit mode stores ds in bf16, as
the TPU package does at "default" on the chip; the two products over it
widen it to fp32 (``_build.bmm_wide``), as the TPU package's einsum
promotes it, and run at the process's precision (TF32).  The forward
reads the precision and its ctx carries it to the backward.  On the CPU
both precisions run the plain version in fp32 (it takes ``precision`` for
the wrapper's signature only).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from vog_tpu_torch.config.defaults import kernel_precision
from vog_tpu_torch.kernels import _build
from vog_tpu_torch.kernels._cluster import SLICE, cluster_args, cluster_plan

NEG = -1e30
NAME = "flash_attention"
NAME_BWD = "flash_attention_bwd"  # recompute mode
NAME_BWD_EMIT = "flash_attention_bwd_emit"
# the kernels' head-dim instances (csrc/tiles.cuh §HeadDim): a call pads
# dh up to the next one, and past the widest takes the cluster kernels
# (kernels/_cluster.py), in SLICE-column blocks
HEAD_DIMS = (64, 128)
BWD_Q_ROWS = 64  # query rows a block of the dq kernels (kRows in csrc/attention.cu)


def head_dim_instance(dh: int) -> Tuple[int, int]:
    """(the columns a block of the kernels that take a head dim of ``dh``
    stages, the blocks a tile of rows has): the narrowest of ``HEAD_DIMS``
    that holds dh and one block, or past the widest a 128-column slice a
    block and ``cluster_plan``'s cluster (passes past 8 slices)."""
    for d in HEAD_DIMS:
        if dh <= d:
            return d, 1
    return SLICE, cluster_plan(dh).cluster


def resolve_bwd_mode(mode: Optional[str]) -> str:
    """The backward's mode, as the TPU package's ``_resolve_bwd_mode``
    picks it: None or "auto" reads ``VOG_FLASH_BWD``, whose "auto" (or
    absence) means "recompute"; anything but "emit" and "recompute"
    raises."""
    if mode is None or mode == "auto":
        mode = os.environ.get("VOG_FLASH_BWD", "auto")
    if mode == "auto":
        mode = "recompute"
    if mode not in ("emit", "recompute"):
        raise ValueError(f"bad flash bwd_mode {mode!r}")
    return mode


def _bias_inputs(H, T, frame_bias, frame_ids, device):
    if frame_bias is None:
        # no bias: the zero (H,1,1) table and zero frame ids, as the TPU path
        frame_bias = torch.zeros((H, 1, 1), dtype=torch.float32, device=device)
        frame_ids = torch.zeros((T,), dtype=torch.int32, device=device)
    return frame_bias, frame_ids


def flash_attention_plain(
    q, k, v, key_mask, frame_bias=None, frame_ids=None, precision=None, scale=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version -> (o (B,H,T,dh), lse (B,H,T)); ``scale``
    (None: 1/sqrt(dh)) is the score scale, as the kernels take it."""
    B, H, T, dh = q.shape
    frame_bias, frame_ids = _bias_inputs(H, T, frame_bias, frame_ids, q.device)
    fid = frame_ids.long()
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dh) if scale is None else scale)
    s = s + frame_bias.float()[:, fid][:, :, fid][None]
    s = torch.where(key_mask[:, None, None, :] > 0, s, torch.full_like(s, NEG))
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.softmax(s, dim=-1), v), lse


def _check_cuda(q, k, v, key_mask, frame_bias, frame_ids):
    """The kernels' argument checks -> (frame count F, pointer of
    frame_bias, pointer of frame_ids); with no bias F = 1 and both
    pointers are None (the kernels add no bias then)."""
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    dev = q.device
    B, H, T, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, torch.float32, 4, dev)
        if tuple(t.shape) != (B, H, T, dh):
            raise ValueError(f"{NAME}: {name} shape {tuple(t.shape)} != q shape")
    _build.require(key_mask, "key_mask", torch.float32, 2, dev)
    if tuple(key_mask.shape) != (B, T):
        raise ValueError(f"{NAME}: key_mask shape {tuple(key_mask.shape)} does not match q")
    if frame_bias is None:
        return 1, None, None
    Fn = frame_bias.shape[-1]
    _build.require(frame_bias, "frame_bias", torch.float32, 3, dev)
    _build.require(frame_ids, "frame_ids", torch.int32, 1, dev)
    if tuple(frame_bias.shape) != (H, Fn, Fn):
        raise ValueError(f"{NAME}: frame_bias shape {tuple(frame_bias.shape)} does not match q")
    if frame_ids.shape[0] != T:
        raise ValueError(f"{NAME}: frame_ids length != T")
    return Fn, frame_bias.data_ptr(), frame_ids.data_ptr()


def _flash_fwd_cuda(q, k, v, key_mask, frame_bias, frame_ids, prec):
    """The forward kernel's launch (the op's CUDA implementation): dh 64
    and 128, past 128 the cluster kernel on q, k, v padded with zero
    columns to a multiple of 4 and starting on 16 bytes (``pad_cols``), as
    clusters of ``cluster_plan``'s size, its output sliced back."""
    Fn, fb_ptr, fid_ptr = _check_cuda(q, k, v, key_mask, frame_bias, frame_ids)
    B, H, T, dh = q.shape
    kd, n, (qk, kk, vk) = cluster_args(dh, q, k, v)  # past 128: cluster_plan's head dim and cluster
    o = torch.empty_like(qk)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    P, I = _build.P, _build.I
    fn = _build.function("attention.cu", "vog_flash_fwd", [P] * 8 + [I] * 5 + [_build.F, I, P], prec)
    rc = fn(q.device.index, qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), key_mask.data_ptr(), fb_ptr,
            fid_ptr, o.data_ptr(), lse.data_ptr(), B, H, T, kd, Fn, 1.0 / math.sqrt(dh), n,
            _build.stream_ptr(q))
    _build.check(rc, NAME)
    _build.count(NAME, prec)
    return (o if kd == dh else o[..., :dh].contiguous()), lse


# the op ``vog::flash_attention_fwd`` (``_build.define_op``)
_build.define_op(
    "flash_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor key_mask, Tensor? frame_bias, "
    "Tensor? frame_ids, str precision) -> (Tensor, Tensor)",
    cuda=_flash_fwd_cuda, cpu=flash_attention_plain,
    fake=lambda q, k, v, key_mask, frame_bias, frame_ids, precision: (
        torch.empty_like(q), q.new_empty(q.shape[:3])))


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    frame_bias: Optional[torch.Tensor] = None,
    frame_ids: Optional[torch.Tensor] = None,
    precision: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k,v (B,H,T,dh) fp32; key_mask (B,T); frame_bias (H,F,F) or None;
    frame_ids (T,) -> (o, lse), through the op ``vog::flash_attention_fwd``.
    ``precision``: "highest" or "default" (None: ``kernel_precision()``)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    return torch.ops.vog.flash_attention_fwd(q, k, v, key_mask, frame_bias, frame_ids,
                                             precision or kernel_precision())


def flash_attention_bwd_plain(q, k, v, key_mask, frame_bias, frame_ids, o, lse, do,
                              bwd_mode=None, precision=None, scale=None):
    """Plain PyTorch backward from the saved LSE -> (dq, dk, dv, dfb (H,F,F)),
    as the TPU kernels' ``_block_tile`` defines it: p = exp(s - lse),
    ds = p (do.v - delta) with delta = sum(do * o), masked keys give ds = 0.
    A batch row with every key masked has lse = -1e30 + log T, which is
    -1e30 in fp32: there p = 1/T (the softmax of equal scores), as
    autograd of ``flash_attention_plain`` gives.  Both modes compute this
    function; ``bwd_mode`` and ``precision`` are taken for the kernel
    wrapper's signature and do not change the arithmetic; ``scale`` is
    the forward's (None: 1/sqrt(dh))."""
    B, H, T, dh = q.shape
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    frame_bias, frame_ids = _bias_inputs(H, T, frame_bias, frame_ids, q.device)
    fid = frame_ids.long()
    valid = key_mask[:, None, None, :] > 0
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + frame_bias.float()[:, fid][:, :, fid][None]
    s = torch.where(valid, s, torch.full_like(s, NEG))
    none = (key_mask > 0).sum(-1) == 0  # (B,)
    p = torch.where(none[:, None, None, None], torch.full_like(s, 1.0 / T), torch.exp(s - lse[..., None]))
    delta = (do * o).sum(-1, keepdim=True)
    ds = torch.where(valid, p * (torch.matmul(do, v.transpose(-1, -2)) - delta), torch.zeros_like(s))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dv = torch.matmul(p.transpose(-1, -2), do)
    onehot = torch.nn.functional.one_hot(fid, frame_bias.shape[-1]).to(ds.dtype)  # (T,F)
    dfb = torch.einsum("fi,bhij,jg->hfg", onehot.t(), ds, onehot)
    return dq, dk, dv, dfb


def flash_attention_bwd(q, k, v, key_mask, frame_bias, frame_ids, o, lse, do, bwd_mode=None,
                        precision=None):
    """Backward of ``flash_attention_fwd`` -> (dq, dk, dv, dfb (H,F,F)): on
    the card the CUDA kernels of ``bwd_mode`` (``resolve_bwd_mode``) at
    ``precision`` (None: ``kernel_precision()``): delta, then dk/dv and dq
    ("recompute"), or dk/dv with ds (bf16 at "default") and two products
    over it ("emit"); the plain version on the CPU."""
    mode = resolve_bwd_mode(bwd_mode)
    prec = precision or kernel_precision()
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, key_mask, frame_bias, frame_ids, o, lse, do)
    Fn, fb_ptr, fid_ptr = _check_cuda(q, k, v, key_mask, frame_bias, frame_ids)
    dev = q.device
    B, H, T, dh = q.shape
    for name, t in (("o", o), ("do", do)):
        _build.require(t, name, torch.float32, 4, dev)
        if t.shape != q.shape:
            raise ValueError(f"{NAME_BWD}: {name} shape {tuple(t.shape)} != q shape")
    _build.require(lse, "lse", torch.float32, 3, dev)
    P, I = _build.P, _build.I
    delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)  # rowsum(do * o)
    fn = _build.function("attention.cu", "vog_flash_delta", [P] * 3 + [I] * 2 + [P], prec)
    _build.check(fn(dev.index, o.data_ptr(), do.data_ptr(), delta.data_ptr(), B * H * T, dh,
                    _build.stream_ptr(q)), NAME_BWD)
    scale = 1.0 / math.sqrt(dh)
    kd, n, (qk, kk, vk, dok) = cluster_args(dh, q, k, v, do)  # past 128: cluster_plan's head dim and cluster
    dk, dv = torch.empty_like(kk), torch.empty_like(vk)
    if mode == "emit":
        ds_type = torch.float32 if prec == "highest" else torch.bfloat16
        ds = torch.empty((B * H, T, T), dtype=ds_type, device=dev)
        dq = part = None
    else:
        ds = None
        dq = torch.empty_like(qk)
        # the kernel writes the frame-bias partials only when F > 1
        part = (torch.empty((B, H, -(-T // BWD_Q_ROWS), Fn, Fn), dtype=torch.float32, device=dev)
                if Fn > 1 else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _build.function("attention.cu", "vog_flash_bwd", [P] * 14 + [I] * 5 + [_build.F, I, P], prec)
    rc = fn(dev.index, qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), dok.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), key_mask.data_ptr(), fb_ptr, fid_ptr, ptr(dq),
            dk.data_ptr(), dv.data_ptr(), ptr(part), ptr(ds), B, H, T, kd, Fn, scale, n,
            _build.stream_ptr(q))
    if kd != dh:
        dk, dv = dk[..., :dh].contiguous(), dv[..., :dh].contiguous()
        dq = None if dq is None else dq[..., :dh].contiguous()
    zeros = lambda: torch.zeros((H, 1, 1), dtype=torch.float32, device=dev)  # noqa: E731
    if mode == "emit":
        _build.check(rc, NAME_BWD_EMIT)
        _build.count(NAME_BWD_EMIT, prec)
        dq = _build.bmm_wide(ds, k.reshape(B * H, T, dh)).reshape(q.shape) * scale
        if Fn == 1:
            return dq, dk, dv, zeros()
        onehot = torch.nn.functional.one_hot(frame_ids.long(), Fn).float()  # (T,F)
        dfb = torch.matmul(onehot.t(), _build.bmm_wide(ds, onehot))  # (BH,F,F)
        return dq, dk, dv, dfb.reshape(B, H, Fn, Fn).sum(0)
    _build.check(rc, NAME_BWD)
    _build.count(NAME_BWD, prec)
    return dq, dk, dv, zeros() if part is None else part.sum(dim=(0, 2))


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, frame_bias, frame_ids, bwd_mode):
        ctx.precision = kernel_precision()
        o, lse = flash_attention_fwd(q, k, v, key_mask, frame_bias, frame_ids, ctx.precision)
        ctx.has_bias = frame_bias is not None
        ctx.bwd_mode = bwd_mode
        ctx.save_for_backward(q, k, v, key_mask, frame_bias, frame_ids, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, frame_bias, frame_ids, o, lse = ctx.saved_tensors
        dq, dk, dv, dfb = flash_attention_bwd(
            q, k, v, key_mask, frame_bias, frame_ids, o, lse, do.contiguous(), bwd_mode=ctx.bwd_mode,
            precision=ctx.precision)
        _build.check_outputs(NAME_BWD_EMIT if ctx.bwd_mode == "emit" else NAME_BWD, dq, dk, dv, dfb)
        return dq, dk, dv, None, (dfb if ctx.has_bias else None), None, None


def flash_attention(q, k, v, key_mask, frame_bias=None, frame_ids=None,
                    bwd_mode: Optional[str] = None) -> torch.Tensor:
    """Fused attention -> (B,H,T,dh), the JAX package's signature, with
    its gradient (``FlashAttention``) where an input requires one (else
    the forward op alone); ``bwd_mode`` ("emit", "recompute", "auto" or
    None) is resolved here, at the call, as the TPU package resolves it."""
    mode = resolve_bwd_mode(bwd_mode)
    if not _build.needs_grad(q, k, v, frame_bias):  # inference, an export: the op alone
        return flash_attention_fwd(q, k, v, key_mask, frame_bias, frame_ids)[0]
    return FlashAttention.apply(q, k, v, key_mask, frame_bias, frame_ids, mode)
