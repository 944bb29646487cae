"""Sequence-parallel ring attention over the mesh's model axis
(counterpart of vog_tpu/kernels/ring_attention.py).

The token axis of one example's self-attention is sharded over the model
ranks: each holds its (B, H, T/m, dh) block of q, k and v (fp32) and the
matching blocks of the key mask and the frame ids; the (H, F, F)
relative-frame bias is whole on every rank.  In m ring steps each rank
merges the (k, v) block it holds into an online-softmax state (m, l, acc),
the flash-attention merge, then sends the block, its key mask and its
frame ids to the next model index (``Mesh.shift``: a P2P send and receive
over the model group).  The bias rides along as the (H, Tq, Tk) gather of
the table at the block pair's frame ids, so no (T, T) bias exists.  After
m steps ``acc / l`` is the softmax over all T keys.  Masked keys take the
finite value -0.5 * finfo(float32).max, as the JAX ring does, so a block
whose keys are all padding stays NaN-free.  The block products are
``torch.matmul``: the JAX ring computes its blocks with einsums outside
any Pallas kernel.

Autograd does not pass through P2P sends, so the backward is written out
(``_Ring.backward``), a second ring: with the output and the softmax
statistics (m, l) saved, each step recomputes the block's probabilities,
adds the block's share to dq (kept) and to the block's dk and dv
accumulators, which travel with (k, v); after m sends they are back with
the block's owner.
The frame-bias gradient is each rank's partial sum over its query block;
the caller sums it over the model axis (train/state.py sums the
``rpe_table`` gradient with the step's other partial leaves).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -0.5 * torch.finfo(torch.float32).max  # the finite mask value


def _rotate(mesh, *ts: torch.Tensor):
    """Send ``ts`` to the next model index as one buffer (int32 tensors
    travel as their bits); -> the previous index's, in the same shapes."""
    flat = torch.cat([(t.view(torch.float32) if t.dtype == torch.int32 else t).reshape(-1) for t in ts])
    got = mesh.shift(flat)
    out, o = [], 0
    for t in ts:
        n = t.numel()
        piece = got[o:o + n].view(t.shape)
        out.append(piece.view(torch.int32) if t.dtype == torch.int32 else piece)
        o += n
    return out


def _logits(q, kb, mb, frame_bias, fq, fk):
    """(B, H, Tq, Tk) scores of q against the block: scaled products, the
    block pair's bias, the mask."""
    s = torch.matmul(q, kb.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if frame_bias is not None:
        s = s + frame_bias[:, fq.long()][:, :, fk.long()][None]
    return torch.where(mb[:, None, None, :] > 0, s, torch.full_like(s, NEG))


def _one_hot(fid: torch.Tensor, n: int) -> torch.Tensor:
    return (fid.long()[:, None] == torch.arange(n, device=fid.device)[None]).float()


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, frame_ids, frame_bias, mesh):
        n = mesh.model
        B, H, Tl, dh = q.shape
        m = torch.full((B, H, Tl), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q)
        kb, vb, mb, fb = k, v, key_mask, frame_ids
        for s in range(n):
            logits = _logits(q, kb, mb, frame_bias, frame_ids, fb)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vb)
            m = m_new
            if s < n - 1:
                kb, vb, mb, fb = _rotate(mesh, kb, vb, mb, fb)
        out = acc / l[..., None]
        ctx.mesh = mesh
        # m and l apart, not as m + log(l): a row whose keys are all padding
        # has m = NEG, where adding log(l) is lost to rounding
        ctx.save_for_backward(q, k, v, key_mask, frame_ids, frame_bias, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, frame_ids, frame_bias, out, m, l = ctx.saved_tensors
        mesh = ctx.mesh
        n = mesh.model
        scale = 1.0 / math.sqrt(q.shape[-1])
        dout = dout.contiguous()
        delta = (dout * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(q)
        dkb, dvb = torch.zeros_like(k), torch.zeros_like(v)
        dbias = None if frame_bias is None else torch.zeros_like(frame_bias)
        F = 0 if frame_bias is None else frame_bias.shape[-1]
        oq = None if frame_bias is None else _one_hot(frame_ids, F)
        kb, vb, mb, fb = k, v, key_mask, frame_ids
        for s in range(n):
            p = torch.exp(_logits(q, kb, mb, frame_bias, frame_ids, fb) - m[..., None]) / l[..., None]
            dvb = dvb + torch.matmul(p.transpose(-1, -2), dout)
            ds = p * (torch.matmul(dout, vb.transpose(-1, -2)) - delta)
            ds = torch.where(mb[:, None, None, :] > 0, ds, torch.zeros_like(ds))  # the mask's where
            dq = dq + torch.matmul(ds, kb) * scale
            dkb = dkb + torch.matmul(ds.transpose(-1, -2), q) * scale
            if dbias is not None:  # sum ds over the batch and over each frame pair
                dbias = dbias + torch.matmul(torch.matmul(oq.t(), ds.sum(dim=0)), _one_hot(fb, F))
            if s < n - 1:
                kb, vb, mb, fb, dkb, dvb = _rotate(mesh, kb, vb, mb, fb, dkb, dvb)
            else:  # the accumulators' last step home
                dkb, dvb = _rotate(mesh, dkb, dvb)
        return dq, dkb, dvb, None, None, dbias, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
                   frame_bias: Optional[torch.Tensor], frame_ids: Optional[torch.Tensor], mesh) -> torch.Tensor:
    """Attention of this model rank's token block over all T tokens:
    q/k/v (B, H, T/m, dh) fp32 blocks, ``key_mask`` (B, T/m) 1 = valid,
    ``frame_ids`` (T/m,) the block's, ``frame_bias`` (H, F, F) whole or
    None -> (B, H, T/m, dh) fp32.  A collective of the model group: every
    model rank calls it with its block."""
    if frame_ids is None:
        frame_ids = torch.zeros(q.shape[2], dtype=torch.int32, device=q.device)
        frame_bias = None
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), key_mask.float().contiguous(),
                       frame_ids.to(torch.int32).contiguous(), frame_bias, mesh)
