"""Attention forward with a factored relative-frame bias, fp32.

  o = softmax_j(q_i.k_j / sqrt(dh) + fb[h, fid_i, fid_j], key-masked) . v

Replaces vog_tpu/kernels/attention.py §_fwd_call (_fwd_kernel,
_bias_block).  CUDA kernel: csrc/attention.cu.  On the H100 it is bound by
fp32 operations at GT5 shapes; the kernel runs an online softmax over
32-key tiles (the TPU kernel's whole-key-axis block does not fit 227 KB of
shared memory at T=4000) and reads the bias from the head's (F, F) table
in shared memory instead of the TPU kernel's one-hot matmul.  Masked keys
take the finite ``NEG`` so a row with every key masked stays finite.
Forward only: the backward kernels come with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vog_tpu_torch.kernels import _build

NEG = -1e30
NAME = "flash_attention"


def _bias_inputs(H, T, frame_bias, frame_ids, device):
    if frame_bias is None:
        # no bias: the zero (H,1,1) table and zero frame ids, as the TPU path
        frame_bias = torch.zeros((H, 1, 1), dtype=torch.float32, device=device)
        frame_ids = torch.zeros((T,), dtype=torch.int32, device=device)
    return frame_bias, frame_ids


def flash_attention_plain(
    q, k, v, key_mask, frame_bias=None, frame_ids=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version -> (o (B,H,T,dh), lse (B,H,T))."""
    B, H, T, dh = q.shape
    frame_bias, frame_ids = _bias_inputs(H, T, frame_bias, frame_ids, q.device)
    fid = frame_ids.long()
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    s = s + frame_bias.float()[:, fid][:, :, fid][None]
    s = torch.where(key_mask[:, None, None, :] > 0, s, torch.full_like(s, NEG))
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.softmax(s, dim=-1), v), lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    frame_bias: Optional[torch.Tensor] = None,
    frame_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k,v (B,H,T,dh) fp32; key_mask (B,T); frame_bias (H,F,F) or None;
    frame_ids (T,) -> (o, lse)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, frame_bias, frame_ids)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    dev = q.device
    B, H, T, dh = q.shape
    if dh > 128:
        raise ValueError(f"{NAME}: head dim {dh} > 128 is not supported by the kernel")
    frame_bias, frame_ids = _bias_inputs(H, T, frame_bias, frame_ids, dev)
    Fn = frame_bias.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, torch.float32, 4, dev)
        if tuple(t.shape) != (B, H, T, dh):
            raise ValueError(f"{NAME}: {name} shape {tuple(t.shape)} != q shape")
    _build.require(key_mask, "key_mask", torch.float32, 2, dev)
    _build.require(frame_bias, "frame_bias", torch.float32, 3, dev)
    _build.require(frame_ids, "frame_ids", torch.int32, 1, dev)
    if tuple(key_mask.shape) != (B, T) or tuple(frame_bias.shape) != (H, Fn, Fn):
        raise ValueError(f"{NAME}: key_mask/frame_bias shapes do not match q")
    if frame_ids.shape[0] != T:
        raise ValueError(f"{NAME}: frame_ids length != T")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("attention.cu", "vog_flash_fwd", [P] * 8 + [I] * 5 + [_build.F, P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            frame_bias.data_ptr(), frame_ids.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, T, dh, Fn, 1.0 / math.sqrt(dh),
            _build.stream_ptr(q))
    _build.check(rc, NAME)
    _build.count(NAME)
    return o, lse


def flash_attention(q, k, v, key_mask, frame_bias=None, frame_ids=None) -> torch.Tensor:
    """Fused attention -> (B,H,T,dh), the JAX package's signature."""
    return flash_attention_fwd(q, k, v, key_mask, frame_bias, frame_ids)[0]
