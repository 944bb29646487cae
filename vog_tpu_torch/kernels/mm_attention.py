"""Shared-QK multi-arg attention forward (decomposed first mm layer), fp32.

Per arg a:  out_a = softmax_j(s_ij + cn_aj) . vm,
            s = qm.km^T + fb[h, fid_i, fid_j], key-masked to NEG,
with the 1/sqrt(dh) scale folded into qm by the caller and cn the per-arg
log-domain key weighting in its natural (B,H,A,T) layout.

Replaces vog_tpu/kernels/mm_attention.py §_fwd (_fwd_kernel).  CUDA
kernel: csrc/mm_attention.cu.  Bound by fp32 operations on the H100 (the A
value products dominate); the kernel scores each key tile once for all
args, keeps a per-arg running max and denominator (each final denominator
is >= 1) and an A x dh accumulator per query row, so neither the (T,T)
scores nor the A value streams reach device memory.  No library call
computes this function.  Forward only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vog_tpu_torch.kernels import _build

NEG = -1e30
NAME = "mm_shared_qk_attention"


def mm_attention_plain(qm, km, vm, cn, key_mask, frame_bias, frame_ids):
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


def mm_attention_fwd(
    qm: torch.Tensor,
    km: torch.Tensor,
    vm: torch.Tensor,
    cn: torch.Tensor,
    key_mask: torch.Tensor,
    frame_bias: torch.Tensor,
    frame_ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qm,km,vm (B,H,T,dh) fp32; cn (B,H,A,T); key_mask (B,T) fp32;
    frame_bias (H,F,F); frame_ids (T,) int32 -> (out, row max, den)."""
    if qm.device.type == "cpu":
        return mm_attention_plain(qm, km, vm, cn, key_mask, frame_bias, frame_ids)
    if qm.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {qm.device}")
    dev = qm.device
    B, H, T, dh = qm.shape
    A = cn.shape[2]
    Fn = frame_bias.shape[-1]
    if dh > 128 or not 1 <= A <= 8:
        raise ValueError(f"{NAME}: kernel takes dh <= 128 and 1 <= A <= 8 (dh={dh}, A={A})")
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
    out = torch.empty((B, H, A, T, dh), dtype=torch.float32, device=dev)
    mrow = torch.empty((B, H, A, T), dtype=torch.float32, device=dev)
    den = torch.empty((B, H, A, T), dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("mm_attention.cu", "vog_mm_fwd", [P] * 10 + [I] * 6 + [P])
    rc = fn(qm.data_ptr(), km.data_ptr(), vm.data_ptr(), cn.data_ptr(),
            key_mask.data_ptr(), frame_bias.data_ptr(), frame_ids.data_ptr(),
            out.data_ptr(), mrow.data_ptr(), den.data_ptr(),
            B, H, A, T, dh, Fn, _build.stream_ptr(qm))
    _build.check(rc, NAME)
    _build.count(NAME)
    return out, mrow, den


def mm_shared_qk_attention(qm, km, vm, cn, key_mask, frame_bias, frame_ids) -> torch.Tensor:
    """-> (B,H,A,T,dh), the JAX package's signature."""
    return mm_attention_fwd(qm, km, vm, cn, key_mask, frame_bias, frame_ids)[0]
