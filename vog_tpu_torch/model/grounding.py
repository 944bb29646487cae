"""The model zoo: ImgGrnd, VidGrnd, VOGNet (+ selector).

Counterpart of vog_tpu/model/grounding.py.  Every model consumes the clip
view of ``sampling.assemble_batch`` and returns logits (B', A, T).  The
fused head always goes through the head kernel's wrapper (the CUDA kernels
on the card, the plain versions on the CPU, forward and backward).  The
loss is in ``model/loss.py``.  Under the bf16 activation policy
(``model/dtypes.py``) the visual and multimodal path computes in bf16,
the head kernel takes fp32 operands, and every model returns fp32
logits.

The mesh's model axis (``get_model(..., mesh=)``, train/dist.py): under
tensor parallelism (training, ``misc.mesh_model`` > 1) the model is built
whole from the seed, then each rank keeps its part (``shard_state_dict``);
the encoders' projections, the attention heads and the FFNs are split
(model/transformer.py), and the head, ``mm_proj_*``, ``mm_head``, the
LayerNorms and the language path stay whole on every rank.  With
``mdl.sp_attention`` the attention blocks run the ring; a
``Predictor`` builds the model whole with the ring alone
(``tensor_parallel=False``), as the JAX ``Predictor(mesh=)`` does.
"""


from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from vog_tpu_torch.config import apply_matmul_precision
from vog_tpu_torch.device import DeviceLike, resolve_device
from vog_tpu_torch.kernels.grounding_head import fused_grounding_head
from vog_tpu_torch.model.dtypes import act_dtype, linear
from vog_tpu_torch.model.encoders import LangEncoder, PropEncoder, SegEncoder
from vog_tpu_torch.model.parallel import gather_from_model
from vog_tpu_torch.model.transformer import (
    ObjectTransformer,
    RelMultiHeadAttention,
    RelTransformer,
    RelTransformerDecomposed,
)
from vog_tpu_torch.sampling.conc import view_dims


def _lecun(shape) -> nn.Parameter:
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=1.0 / math.sqrt(shape[0]))
    return nn.Parameter(w)


class GroundingHead(nn.Module):
    """h = relu(W_v vis + b_v + W_l arg + W_x (vis * arg));
    logit = w2 . relu(W1 h + b1) + b2.  Weights keep the JAX package's
    (in, out) layout and names, which is also the kernel's layout."""

    def __init__(self, cfg):
        super().__init__()
        D = cfg.mdl.vis_dim
        Dh = D // 2
        self.fuse_vis_kernel = _lecun((D, D))
        self.fuse_vis_bias = nn.Parameter(torch.zeros(D))
        self.fuse_lang_kernel = _lecun((D, D))
        self.fuse_cross_kernel = _lecun((D, D))
        self.head1_kernel = _lecun((D, Dh))
        self.head1_bias = nn.Parameter(torch.zeros(Dh))
        self.head2_kernel = _lecun((Dh, 1))
        self.head2_bias = nn.Parameter(torch.zeros(1))

    def forward(self, vis: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
        # the stems in the activation dtype (vis's), the params cast per
        # matmul; the kernel's operands fp32, its logits fp32
        dt = vis.dtype
        wv = torch.matmul(vis, self.fuse_vis_kernel.to(dt)) + self.fuse_vis_bias.to(dt)  # (B,T,D)
        wl = torch.matmul(arg, self.fuse_lang_kernel.to(dt))  # (B,A,D)
        f32 = torch.float32
        return fused_grounding_head(
            vis.to(f32).contiguous(), arg.to(f32).contiguous(), wv.to(f32), wl.to(f32),
            self.fuse_cross_kernel,
            self.head1_kernel, self.head1_bias, self.head2_kernel[:, 0].contiguous(),
            self.head2_bias,
        )


class DotGroundingHead(nn.Module):
    """score = <MLP_v(vis_t), MLP_l(arg_a)> / sqrt(D) + bias: the MLPs in
    the activation dtype (vis's), the scores fp32."""

    def __init__(self, cfg):
        super().__init__()
        D = cfg.mdl.vis_dim
        self.v1, self.v2 = nn.Linear(D, D), nn.Linear(D, D)
        self.l1, self.l2 = nn.Linear(D, D), nn.Linear(D, D)
        self.score_bias = nn.Parameter(torch.zeros(()))

    def forward(self, vis: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
        D = vis.shape[-1]
        v = linear(torch.relu(linear(vis, self.v1)), self.v2)
        lg = linear(torch.relu(linear(arg, self.l1)), self.l2)
        return torch.matmul(lg.float(), v.float().transpose(-1, -2)) / math.sqrt(D) + self.score_bias


class ImgGrnd(nn.Module):
    """Per-proposal scoring with no cross-frame reasoning."""

    def __init__(self, cfg, vocab_size: int, n_frames: int, tp=None, sp=None):
        super().__init__()
        self.cfg = cfg
        self.dt = act_dtype(cfg)  # the activation dtype (params stay fp32)
        self.n_frames = n_frames
        self.tp, self.sp = tp, sp
        self.lang = LangEncoder(cfg, vocab_size)
        self.prop_enc = PropEncoder(cfg, tp)
        self.seg_enc = SegEncoder(cfg, tp)
        self.head = DotGroundingHead(cfg) if cfg.mdl.head_type == "dot" else GroundingHead(cfg)

    def encode(self, clip: Dict):
        lang = self.lang(
            clip["tokens"], clip["seq_len"], clip["srl_spans"], clip["srl_roles"], clip["verb_idx"]
        )
        penc = self.prop_enc(clip["props"], clip["boxes"])  # (B,T,D)
        senc = self.seg_enc(clip["seg"])  # (B,F,D)
        vis = gather_from_model(penc + senc[:, clip["frame_ids"].long()], self.tp)  # whole D
        key_mask = clip["mask"].float().contiguous()
        fid = clip["frame_ids"].to(torch.int32).contiguous()
        return vis, lang, key_mask, fid

    def forward(self, clip: Dict) -> torch.Tensor:
        vis, lang, _, _ = self.encode(clip)
        return self.head(vis, lang["arg_rep"])


class VidGrnd(ImgGrnd):
    """ImgGrnd + object transformer (temporal PE self-attention)."""

    def __init__(self, cfg, vocab_size: int, n_frames: int, tp=None, sp=None):
        super().__init__(cfg, vocab_size, n_frames, tp, sp)
        self.obj_tx = ObjectTransformer(cfg, tp, sp)

    def forward(self, clip: Dict) -> torch.Tensor:
        vis, lang, key_mask, fid = self.encode(clip)
        vis = self.obj_tx(vis, key_mask, fid)
        return self.head(vis, lang["arg_rep"])


class VOGNet(ImgGrnd):
    """VidGrnd + multimodal transformer with relative position encoding."""

    def __init__(self, cfg, vocab_size: int, n_frames: int, tp=None, sp=None):
        super().__init__(cfg, vocab_size, n_frames, tp, sp)
        D = cfg.mdl.vis_dim
        self.obj_tx = ObjectTransformer(cfg, tp, sp)
        if cfg.mdl.decomposed_mm:
            self.mm_tx = RelTransformerDecomposed(cfg, n_frames, tp, sp)
        else:
            self.mm_tx = RelTransformer(cfg, n_frames, tp, sp)
        self.mm_proj_vis = nn.Linear(D, D)
        self.mm_proj_arg = nn.Linear(D, D, bias=False)
        self.mm_head = nn.Linear(D, 1)

    def forward(self, clip: Dict) -> torch.Tensor:
        vis, lang, key_mask, fid = self.encode(clip)
        vis = self.obj_tx(vis, key_mask, fid)
        arg = lang["arg_rep"]  # (B,A,D)
        B, T, D = vis.shape
        A = arg.shape[1]
        m = linear(vis, self.mm_proj_vis)
        g = linear(arg, self.mm_proj_arg)
        if self.cfg.mdl.decomposed_mm:
            mm = self.mm_tx(m, g, key_mask, fid)
        else:
            tokens = (m[:, None] + g[:, :, None]).reshape(B * A, T, D)
            mm = self.mm_tx(tokens, key_mask.repeat_interleave(A, dim=0), fid)
        mm = mm.reshape(B, A, T, D)
        logits = self.head(vis, arg)  # fp32
        return logits + linear(torch.relu(mm), self.mm_head)[..., 0].float()


MODELS = {"img_grnd": ImgGrnd, "vid_grnd": VidGrnd, "vog": VOGNet}


def check_kernel_shapes(cfg) -> None:
    """The one place that states the card's kernels' ranges, checked before
    the first forward of a model built on the card (the port's wrappers
    launch their kernel or raise; the JAX package falls back to XLA):
    the attention kernels take any whole head dim of at least 1 (instances
    64 / 128, past 128 the cluster kernels, kernels/_cluster.py), any frame
    count and any arg count (launches of at most 8 args); the fused head
    any D and Dh (zero-padded to multiples of 32 and 16, past 512 and 256
    its wide path) and any arg count (launches of at most 5).  Raises
    ``ValueError``, naming the config key, for a head dim that is not a
    whole number of at least 1 (``mdl.vis_dim`` not a multiple of
    ``mdl.n_heads``), which the JAX package's heads do not take either."""
    mdl = cfg.mdl
    D, H = mdl.vis_dim, mdl.n_heads
    if mdl.name != "img_grnd" and (D < H or D % H):
        raise ValueError(f"the card's kernels do not take this model: mdl.vis_dim / mdl.n_heads = {D} / {H}: "
                         "the attention kernels take a whole head dim of at least 1")


def get_model(
    cfg, vocab_size: int, device: DeviceLike = None, seed: int = 0, train: bool = False,
    glove=None, mesh=None, tensor_parallel: bool = True,
) -> nn.Module:
    """Build the configured model on ``device`` (cuda by default), with
    random weights made from ``seed``, in eval mode, or in train mode
    (dropout on, and cuDNN's BiLSTM backward allowed) when ``train``.
    ``glove``, a ``(vocab_size, mdl.emb_dim)`` array (the vocabulary's
    GloVe table), sets the word embedding, as the JAX package's
    ``LangEncoder`` initialises its ``embed`` param from it; it stays
    frozen unless ``mdl.train_embeddings``.  Without it the embedding is
    random.  The parameters are fp32 whatever ``mdl.dtype`` says (the
    activation dtype, ``model/dtypes.py``).  Applies
    ``misc.matmul_precision``; on the card, checks the kernels' shape
    ranges first (``check_kernel_shapes``).

    ``mesh`` (train/dist.py) with a model axis longer than 1: tensor
    parallelism when ``tensor_parallel`` (this rank keeps its part of the
    whole model the seed makes, ``shard_state_dict``), and the
    sequence-parallel ring when ``mdl.sp_attention``; the model's ``tp``
    and ``sp`` attributes hold the mesh of each, or None."""
    if torch.device("cuda" if device is None else device).type == "cuda":
        check_kernel_shapes(cfg)
    dev = resolve_device(device)
    apply_matmul_precision(cfg)
    ds = cfg.ds
    _, n_frames, _ = view_dims(ds.conc_type, ds.num_cmp, ds.num_frms, ds.num_prop_per_frm)
    axis = mesh is not None and mesh.model > 1
    tp = mesh if axis and tensor_parallel else None
    sp = mesh if axis and cfg.mdl.sp_attention and cfg.mdl.name != "img_grnd" else None
    _, n_f, n_p = view_dims(ds.conc_type, ds.num_cmp, ds.num_frms, ds.num_prop_per_frm)
    if sp is not None and (n_f * n_p) % mesh.model:
        # the JAX dispatch falls back to the whole attention there; a ring
        # block's qkv and out gradients are summed over the model ranks
        raise ValueError(f"mdl.sp_attention: {n_f * n_p} tokens do not split over misc.mesh_model="
                         f"{mesh.model} ranks")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MODELS[cfg.mdl.name](cfg, vocab_size, n_frames)
        for mod in model.modules():
            if isinstance(mod, RelMultiHeadAttention):
                nn.init.normal_(mod.rpe_table, std=0.02)
        if tp is not None or sp is not None:  # the whole model's values, this rank's part of them
            from vog_tpu_torch.train.dist import shard_state_dict

            whole = model.state_dict()
            model = MODELS[cfg.mdl.name](cfg, vocab_size, n_frames, tp, sp)
            model.load_state_dict(shard_state_dict(whole, mesh, cfg) if tp is not None else whole, strict=True)
    if glove is not None:
        table = torch.as_tensor(np.asarray(glove, dtype=np.float32))
        if tuple(table.shape) != tuple(model.lang.embed.weight.shape):
            raise ValueError(f"glove table {tuple(table.shape)} does not match the embedding "
                             f"(vocab_size, mdl.emb_dim) = {tuple(model.lang.embed.weight.shape)}")
        with torch.no_grad():
            model.lang.embed.weight.copy_(table)
    return model.to(dev).train(train)
