"""Transformers: object self-attention + relative-position multimodal.

Counterpart of vog_tpu/model/transformer.py: post-LN layers (LayerNorm
eps 1e-6, as flax), multi-head attention over (B,H,T,dh), and a learned
relative-frame bias factored through frames: a (H, 2K+1) table becomes a
(H, F, F) frame-pair bias that the attention kernel reads per token pair,
so no (T,T) bias exists.

Attention always goes through the kernel wrappers (kernels/attention.py,
kernels/mm_attention.py): on the card they launch the CUDA kernels, on the
CPU they run the plain versions, forward and backward.

Dropout (``mdl.dropout``) sits where the JAX package has it: on the output
of each attention block and on the FFN hidden of each layer.  Its keep
mask is a pure function of a key (from seed, step and microbatch, the step
a device tensor), the site and the element index (``dropout_keep``), in
torch integer ops: the same bits on the CPU and the card, in an eager step
and in a CUDA graph replay, with no generator state; it applies to bf16
tensors unchanged.  It is off in eval mode and at rate 0.

Activation dtype (``model/dtypes.py``): the projections (qkv, out, ff1,
ff2) and the LayerNorms compute and store in the activation dtype, with
fp32 parameters cast per call; the LayerNorm statistics, the attention
kernels' operands and results, and the decomposed layer's per-arg key
term c (and cn) are fp32, each kernel result cast back to the activation
dtype.  The JAX package's T >= 1024 kernel gates
were tuned on a TPU and are not copied.

The mesh's model axis (train/dist.py), given as ``tp`` and ``sp`` (a
``Mesh`` or None) by ``get_model``:

  * ``tp``, tensor parallelism (``param_shardings``' layout): each rank
    holds H/m heads of every attention block (qkv's q, k and v column
    blocks split by heads, its ``rpe_table`` rows sliced at use), ``out``
    row-sharded; ``ff1`` column-sharded, its dropout numbering the rank's
    columns from their global offset, ``ff2`` row-sharded
    (model/parallel.py).  The kernels run at H/m heads.
  * ``sp``, the sequence-parallel ring (``mdl.sp_attention``): the
    object transformer's and the materialised multimodal layers'
    attention blocks keep qkv and out whole, project only their rank's
    T/m token block, run ``kernels/ring_attention.py`` and all-gather the
    block's output over T; the block's dropout sees the gathered (B, T, D)
    output (``get_model`` refuses a T that m does not divide).  The
    decomposed first mm layer keeps the mm kernel (heads split under
    ``tp``).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fn

from vog_tpu_torch.kernels.attention import flash_attention
from vog_tpu_torch.kernels.mm_attention import mm_shared_qk_attention
from vog_tpu_torch.kernels.ring_attention import ring_attention
from vog_tpu_torch.model.dtypes import LayerNorm, act_dtype, linear
from vog_tpu_torch.model.parallel import copy_to_model, gather_from_model, row_linear


def sinusoidal_pe(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal encoding of integer positions -> (len(pos), dim)."""
    pos = positions.float()[:, None]
    half = dim // 2
    freq = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    ang = pos * freq[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if pe.shape[-1] < dim:
        pe = Fn.pad(pe, (0, dim - pe.shape[-1]))
    return pe


def _frame_dist(n_frames: int, K: int) -> torch.Tensor:
    f = np.arange(n_frames)
    return torch.from_numpy(np.clip(f[:, None] - f[None, :], -K, K) + K)


M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 tensors holding uint32 values, in 16-bit
    halves of c so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser (a bijection) on int64 uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _mix32_host(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> the int32 of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def dropout_key(seed: int, step: torch.Tensor, micro: int = 0) -> torch.Tensor:
    """The key of (seed, step, microbatch): an int64 0-dim tensor on the
    step's device holding a uint32 value.  ``step`` may be a device tensor
    (the train state's), so the key needs no host read."""
    h = _mix32_host(_mix32_host(seed) ^ _mix32_host(seed >> 32) ^ 0x9E3779B9)
    k = _mix32(torch.as_tensor(step).to(torch.int64).reshape(()) & M32 ^ h)
    return _mix32(k ^ _mix32_host(micro ^ 0x7F4A7C15))


def dropout_keep(key: torch.Tensor, site: int, shape, rate: float, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """The keep mask (bool, ``shape``) of site ``site`` under ``key``:
    element (r, c) of the (rows, shape[-1]) view keeps when a hash of
    (key, site, row0 + r, col0 + c) is at least ``rate`` of the way through
    the 32-bit range (``row0``: the view's first row in the global batch;
    ``col0``: its first column in the whole tensor, for a column shard).  The row and column hashes are full murmur3 mixes of their
    counters under a site key; the element's two rounds of multiply and
    xorshift in int32 (which wraps, as on every platform torch runs on)
    make the keep probability 1 - rate to 2**-32."""
    dev = key.device
    n = 1
    for d in shape:
        n *= int(d)
    W = int(shape[-1]) if len(shape) else 1
    R = n // W if W else 0
    ks = _mix32(key ^ _mix32_host(site * 0x9E3779B9 + 1))
    rows = _mix32(torch.arange(row0, row0 + R, dtype=torch.int64, device=dev) ^ ks)
    cols = _mix32(torch.arange(col0, col0 + W, dtype=torch.int64, device=dev) ^ _mix32(ks ^ 0x5BD1E995))
    x = _as_int32(rows)[:, None] ^ _as_int32(cols)[None, :]
    x = x * 0x2C1B3C6D
    x = x ^ (x >> 15)
    x = x * 0x297A2D39
    thr = int(round(rate * 2.0 ** 32)) - (1 << 31)
    return (x >= thr).reshape(shape)


class Dropout(nn.Module):
    """Inverted dropout with the counter-based mask of ``dropout_keep``
    under the key set by ``set_dropout_key``; ``site`` is this module's
    place among the model's dropout modules.  ``samples`` = (first, n):
    the input's n samples are samples [first, first + n) of the global
    batch (a rank's rows under data parallelism), and its leading dims
    fold them batch first, so its rows are numbered from first * rows a
    sample: every rank draws the bits that one process on the global
    batch draws for the same rows.  ``col0``: the input's first column in
    the whole tensor (a column shard's offset under tensor parallelism)."""

    def __init__(self, rate: float, col0: int = 0):
        super().__init__()
        self.rate = float(rate)
        self.col0 = int(col0)
        self.key = None
        self.site = 0
        self.samples = (0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.key is None:
            raise RuntimeError("dropout in train mode needs set_dropout_key first")
        first, n = self.samples
        row0 = 0
        if first:
            rows = x.numel() // x.shape[-1]
            if rows % n:
                raise ValueError(f"dropout: {rows} rows do not fold {n} samples")
            row0 = first * (rows // n)
        keep = dropout_keep(self.key, self.site, x.shape, self.rate, row0, self.col0)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_dropout_key(model: nn.Module, key, samples=(0, 1)) -> None:
    """Give every dropout site of ``model`` the key, its site number (its
    place in ``model.modules()``) and the global batch's ``samples``
    (first, n) that the next forward holds (``Dropout``)."""
    for site, m in enumerate(m for m in model.modules() if isinstance(m, Dropout)):
        m.key, m.site, m.samples = key, site, (int(samples[0]), int(samples[1]))


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, L, D = t.shape
    return t.reshape(B, L, H, D // H).permute(0, 2, 1, 3).contiguous()


def _ways(mesh) -> int:
    return mesh.model if mesh is not None else 1


class MultiHeadAttention(nn.Module):
    """MHA with no positional bias (the object transformer adds PE).
    ``tp``: this rank's H/m heads, ``out`` row-sharded; ``sp``: the ring
    over T (qkv and out whole)."""

    def __init__(self, cfg, tp=None, sp=None):
        super().__init__()
        D = cfg.mdl.vis_dim
        self.sp = sp
        self.tp = None if sp is not None else tp
        m = _ways(self.tp)
        self.H, self.h0 = cfg.mdl.n_heads // m, (self.tp.model_index if self.tp else 0) * (cfg.mdl.n_heads // m)
        self.dh = D // cfg.mdl.n_heads
        self.dt = act_dtype(cfg)
        self.qkv = nn.Linear(D, 3 * D // m)
        self.out = nn.Linear(D // m, D)
        self.drop = Dropout(cfg.mdl.dropout)

    def frame_bias(self):
        return None

    def forward(self, x, key_mask, frame_ids):
        B, T, D = x.shape
        if self.sp is not None:
            return self.drop(self._ring(x, key_mask, frame_ids))
        x = copy_to_model(x, self.tp)
        q, k, v = (_heads(t, self.H).float() for t in linear(x, self.qkv, self.dt).chunk(3, dim=-1))
        fb = self.frame_bias()
        o = (flash_attention(q, k, v, key_mask) if fb is None else
             flash_attention(q, k, v, key_mask, fb, frame_ids)).to(self.dt)  # kernel operands fp32
        return self.drop(row_linear(o.permute(0, 2, 1, 3).reshape(B, T, self.H * self.dh), self.out, self.tp))

    def _ring(self, x, key_mask, frame_ids):
        """This rank's T/m tokens projected, attended over all T by the
        ring, ``out`` applied, the blocks gathered over T."""
        sp = self.sp
        B, T, D = x.shape
        n = T // sp.model
        lo = sp.model_index * n
        xs = copy_to_model(x, sp)[:, lo:lo + n]
        q, k, v = (_heads(t, self.H).float() for t in linear(xs, self.qkv, self.dt).chunk(3, dim=-1))
        o = ring_attention(q, k, v, key_mask[:, lo:lo + n], self.frame_bias(), frame_ids[lo:lo + n], sp)
        o = linear(o.to(self.dt).permute(0, 2, 1, 3).reshape(B, n, D), self.out)
        return gather_from_model(o, sp, dim=1)


class RelMultiHeadAttention(MultiHeadAttention):
    """MHA with a learned relative-frame-distance bias."""

    def __init__(self, cfg, n_frames: int, tp=None, sp=None):
        super().__init__(cfg, tp, sp)
        K = cfg.mdl.rpe_max_dist
        self.rpe_table = nn.Parameter(torch.zeros(cfg.mdl.n_heads, 2 * K + 1))
        self.register_buffer("dist", _frame_dist(n_frames, K), persistent=False)

    def frame_bias(self) -> torch.Tensor:
        """(H, F, F) of this rank's heads."""
        return self.rpe_table[self.h0:self.h0 + self.H][:, self.dist].contiguous()


class DecomposedRelAttention(RelMultiHeadAttention):
    """Arg-decomposed relative attention for VOGNet's first mm layer.

    Tokens are x_{a,t} = m_t + g_a.  Per head and arg the logits are
    s_ij + c_aj with the shared s = qm_i.km_j (+ bias) and the per-arg key
    term c_aj = qg_a.km_j; every other term is constant over j and cancels
    in the softmax.  So one shared score matrix serves all A args through
    the combined-logit softmax softmax_j(s_ij + c_aj), and vg_a shifts each
    output since the probabilities sum to 1.  The kernel takes
    cn = c - max_j c and the pre-scaled qm, in fp32.  In bf16 the g-part is
    qkv(g) - qkv(0), as the JAX package forms it in the activation dtype;
    in fp32 it is the bias-free product (the same value).  It keeps the mm
    kernel under ``mdl.sp_attention`` (its heads split under ``tp``)."""

    def __init__(self, cfg, n_frames: int, tp=None):
        super().__init__(cfg, n_frames, tp, None)

    def forward(self, m, g, key_mask, frame_ids):
        B, T, D = m.shape
        A = g.shape[1]
        H, dh, dt = self.H, self.dh, self.dt
        m, g = copy_to_model(m, self.tp), copy_to_model(g, self.tp)
        qm, km, vm = (_heads(t, H).float() for t in linear(m, self.qkv, dt).chunk(3, dim=-1))
        # the bias lives in the m-part; the g-part is the linear part only
        if dt == torch.float32:
            g_lin = Fn.linear(g, self.qkv.weight)
        else:
            g_lin = linear(g, self.qkv, dt) - self.qkv.bias.to(dt)  # qkv(g) - qkv(0)
        qg, kg, vg = (_heads(t, H) for t in g_lin.chunk(3, dim=-1))
        scale = 1.0 / math.sqrt(dh)
        c = torch.matmul(qg.float(), km.transpose(-1, -2)) * scale  # (B,H,A,T) fp32
        c = torch.where(key_mask[:, None, None, :] > 0, c, torch.zeros_like(c))
        cn = (c - c.amax(dim=-1, keepdim=True)).contiguous()
        pv = mm_shared_qk_attention(
            (qm * scale).contiguous(), km, vm, cn, key_mask, self.frame_bias(), frame_ids
        )  # (B,H,A,T,dh) fp32
        out = (pv + vg.float()[:, :, :, None]).to(dt)
        out = out.permute(0, 2, 3, 1, 4).reshape(B, A, T, H * dh)
        return self.drop(row_linear(out, self.out, self.tp))


class TxLayer(nn.Module):
    """Post-LN encoder layer: attention -> add&norm -> FFN -> add&norm.
    ``tp``: ff1 column-sharded, ff2 row-sharded."""

    def __init__(self, cfg, relative: bool = False, n_frames: int = 0, tp=None, sp=None):
        super().__init__()
        D = cfg.mdl.vis_dim
        self.tp = tp
        m = _ways(tp)
        hidden = cfg.mdl.ff_mult * D // m
        self.attn = RelMultiHeadAttention(cfg, n_frames, tp, sp) if relative else MultiHeadAttention(cfg, tp, sp)
        self.ln1 = LayerNorm(D, eps=1e-6)
        self.ff1 = nn.Linear(D, hidden)
        self.ff2 = nn.Linear(hidden, D)
        self.ln2 = LayerNorm(D, eps=1e-6)
        self.drop = Dropout(cfg.mdl.dropout, col0=(tp.model_index if tp else 0) * hidden)

    def forward(self, x, key_mask, frame_ids):
        x = self.ln1(x + self.attn(x, key_mask, frame_ids))
        return self.ln2(x + self.ffn(x))

    def ffn(self, x):
        """ff2(dropout(relu(ff1(x)))) in x's dtype."""
        h = self.drop(torch.relu(linear(copy_to_model(x, self.tp), self.ff1)))
        return row_linear(h, self.ff2, self.tp)


class ObjectTransformer(nn.Module):
    """Self-attention over all (frame, prop) tokens with sinusoidal PE on
    the frame index."""

    def __init__(self, cfg, tp=None, sp=None):
        super().__init__()
        self.layers = nn.ModuleList(TxLayer(cfg, tp=tp, sp=sp) for _ in range(cfg.mdl.obj_tx_layers))

    def forward(self, vis, key_mask, frame_ids):
        x = vis + sinusoidal_pe(frame_ids, vis.shape[-1])[None].to(vis.dtype)
        for layer in self.layers:
            x = layer(x, key_mask, frame_ids)
        return x


class RelTransformer(nn.Module):
    """VOGNet's multimodal transformer with relative position encoding."""

    def __init__(self, cfg, n_frames: int, tp=None, sp=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TxLayer(cfg, relative=True, n_frames=n_frames, tp=tp, sp=sp) for _ in range(cfg.mdl.mm_tx_layers)
        )

    def forward(self, x, key_mask, frame_ids):
        for layer in self.layers:
            x = layer(x, key_mask, frame_ids)
        return x


class DecomposedRelTxLayer(TxLayer):
    """First mm layer on the (m, g) decomposition -> (B*A, T, D)."""

    def __init__(self, cfg, n_frames: int, tp=None):
        super().__init__(cfg, relative=True, n_frames=n_frames, tp=tp)
        self.attn = DecomposedRelAttention(cfg, n_frames, tp)

    def forward(self, m, g, key_mask, frame_ids):
        B, T, D = m.shape
        A = g.shape[1]
        attn = self.attn(m, g, key_mask, frame_ids)  # (B,A,T,D)
        x = self.ln1((m[:, None] + g[:, :, None] + attn).reshape(B * A, T, D))
        return self.ln2(x + self.ffn(x))


class RelTransformerDecomposed(nn.Module):
    """RelTransformer whose first layer takes the (m, g) decomposition;
    later layers run on the materialised (B*A, T) tokens."""

    def __init__(self, cfg, n_frames: int, tp=None, sp=None):
        super().__init__()
        layers: List[nn.Module] = [DecomposedRelTxLayer(cfg, n_frames, tp)]
        layers += [TxLayer(cfg, relative=True, n_frames=n_frames, tp=tp, sp=sp)
                   for _ in range(1, cfg.mdl.mm_tx_layers)]
        self.layers = nn.ModuleList(layers)

    def forward(self, m, g, key_mask, frame_ids):
        A = g.shape[1]
        x = self.layers[0](m, g, key_mask, frame_ids)
        key_mask_a = key_mask.repeat_interleave(A, dim=0)
        for layer in self.layers[1:]:
            x = layer(x, key_mask_a, frame_ids)
        return x
