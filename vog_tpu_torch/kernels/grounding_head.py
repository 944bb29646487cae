"""Fused cross-MLP grounding head forward, fp32.

  logit[b,a,t] = w2 . relu(relu(wv_t + wl_a + (vis_t * arg_a) @ Wx) @ W1 + b1) + b2

Replaces vog_tpu/kernels/grounding_head.py §_fwd_call (_fwd_kernel).  CUDA
kernel: csrc/grounding_head.cu.  Bound by operations on the H100 (12.6
GFLOP against ~13 MB of inputs at GT5, B=16); the products run on the
tensor cores in 3xTF32 (fp32-level accuracy); a block owns (b, 16 tokens)
for all A args, keeps the (A*16, D) cross and hidden tiles in shared
memory and writes only the (B,A,T) logits.  The stems ``wv``
(with its bias) and ``wl`` are computed by the caller.  Weights keep the
JAX layout: Wx (D_in, D), W1 (D, Dh).  No single library call computes
this function.  Forward only.
"""

from __future__ import annotations

import torch

from vog_tpu_torch.kernels import _build

NAME = "fused_grounding_head"


def grounding_head_plain(vis, arg, wv, wl, wx, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version -> (B,A,T)."""
    cross = vis[:, None] * arg[:, :, None]  # (B,A,T,D)
    h = torch.relu(wv[:, None] + wl[:, :, None] + torch.matmul(cross, wx))
    h1 = torch.relu(torch.matmul(h, w1) + b1)
    return torch.matmul(h1, w2) + b2


def fused_grounding_head(
    vis: torch.Tensor,  # (B,T,D)
    arg: torch.Tensor,  # (B,A,D)
    wv: torch.Tensor,  # (B,T,D)
    wl: torch.Tensor,  # (B,A,D)
    wx: torch.Tensor,  # (D,D)
    w1: torch.Tensor,  # (D,Dh)
    b1: torch.Tensor,  # (Dh,)
    w2: torch.Tensor,  # (Dh,)
    b2: torch.Tensor,  # () or (1,)
) -> torch.Tensor:
    """-> logits (B,A,T)."""
    if vis.device.type == "cpu":
        return grounding_head_plain(vis, arg, wv, wl, wx, w1, b1, w2, b2)
    if vis.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {vis.device}")
    dev = vis.device
    B, T, D = vis.shape
    A = arg.shape[1]
    Dh = w1.shape[1]
    if D > 512 or D % 32 or Dh > 256 or Dh % 16 or not 1 <= A <= 5:
        raise ValueError(
            f"{NAME}: kernel takes D <= 512 with D % 32 == 0, Dh <= 256 with Dh % 16 == 0, "
            f"1 <= A <= 5 (D={D}, Dh={Dh}, A={A})"
        )
    f32 = torch.float32
    for name, t, shape in (
        ("vis", vis, (B, T, D)), ("wv", wv, (B, T, D)), ("arg", arg, (B, A, D)),
        ("wl", wl, (B, A, D)), ("wx", wx, (D, D)), ("w1", w1, (D, Dh)),
        ("b1", b1, (Dh,)), ("w2", w2, (Dh,)),
    ):
        _build.require(t, name, f32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} shape {tuple(t.shape)} != {shape}")
    if b2.numel() != 1 or b2.device != dev or b2.dtype != f32:
        raise ValueError(f"{NAME}: b2 must be one fp32 value on {dev}")
    b2 = b2.reshape(1).contiguous()
    out = torch.empty((B, A, T), dtype=f32, device=dev)
    P, I = _build.P, _build.I
    fn = _build.function("grounding_head.cu", "vog_head_fwd", [P] * 10 + [I] * 5 + [P])
    rc = fn(vis.data_ptr(), arg.data_ptr(), wv.data_ptr(), wl.data_ptr(),
            wx.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), B, A, T, D, Dh, _build.stream_ptr(vis))
    _build.check(rc, NAME)
    _build.count(NAME)
    return out
