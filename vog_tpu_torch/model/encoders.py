"""Language and visual encoders (counterpart of vog_tpu/model/encoders.py).

  * LangEncoder: GloVe embedding (frozen unless ``mdl.train_embeddings``,
    as the JAX package's stop_gradient) -> BiLSTM -> per-arg rep =
    relu(Linear([span mean ; role embedding ; verb hidden state])).
  * PropEncoder: relu(Linear([RoI fc6 ; 5-d box])).
  * SegEncoder: relu(Linear(TSN segment feature)).

The BiLSTM and the language path run fp32; the arg rep handed to the
visual fusion, and the two visual encoders, follow the activation dtype
(``model/dtypes.py``).  Under tensor parallelism (``tp``, a ``Mesh``) the
two visual projections are column-sharded: each rank computes its block
of the D output features (relu on the local columns), and the model
gathers them once (model/grounding.py §encode).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from vog_tpu_torch.model.dtypes import act_dtype, linear
from vog_tpu_torch.model.lstm import TorchBiLSTM


def span_pool(hidden: torch.Tensor, spans: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
    """Masked mean of hidden (B,L,D) over each arg's inclusive token span
    (B,A,2) -> (B,A,D); empty spans give zeros."""
    B, L, D = hidden.shape
    t = torch.arange(L, device=hidden.device)[None, None, :]
    s, e = spans[..., 0:1], spans[..., 1:2]
    in_span = (t >= s) & (t <= e) & (t < seq_len[:, None, None])
    w = in_span.to(hidden.dtype)
    denom = w.sum(-1, keepdim=True).clamp(min=1.0)
    return torch.matmul(w / denom, hidden)


class LangEncoder(nn.Module):
    def __init__(self, cfg, vocab_size: int):
        super().__init__()
        m = cfg.mdl
        self.train_embeddings = bool(m.train_embeddings)
        self.dt = act_dtype(cfg)
        self.embed = nn.Embedding(vocab_size, m.emb_dim)
        self.bilstm = TorchBiLSTM(m.emb_dim, m.lstm_dim)
        self.role_embed = nn.Embedding(cfg.ds.num_roles, m.role_dim)
        self.arg_proj = nn.Linear(4 * m.lstm_dim + m.role_dim, m.vis_dim)

    def forward(self, tokens, seq_len, srl_spans, srl_roles, verb_idx) -> Dict:
        table = self.embed.weight if self.train_embeddings else self.embed.weight.detach()
        x = Fn.embedding(tokens.long(), table)  # (B,L,emb)
        y, _ = self.bilstm(x, seq_len)
        arg_span = span_pool(y, srl_spans, seq_len)  # (B,A,2H)
        role_emb = self.role_embed(srl_roles.long())  # (B,A,role_dim)
        B, L, _ = y.shape
        vi = verb_idx.long().clamp(0, L - 1)
        verb_rep = y[torch.arange(B, device=y.device), vi]  # (B,2H)
        A = arg_span.shape[1]
        verb_tiled = verb_rep[:, None].expand(B, A, verb_rep.shape[-1])
        arg_rep = torch.relu(self.arg_proj(torch.cat([arg_span, role_emb, verb_tiled], dim=-1)))
        # the language path stays fp32; only the rep handed to the visual
        # fusion follows the activation dtype
        arg_rep = arg_rep.to(self.dt)
        return {"arg_rep": arg_rep, "verb_rep": verb_rep, "hidden": y}


class PropEncoder(nn.Module):
    def __init__(self, cfg, tp=None):
        super().__init__()
        self.prop_proj = nn.Linear(cfg.ds.prop_dim + 5, cfg.mdl.vis_dim // (tp.model if tp else 1))
        self.dt = act_dtype(cfg)

    def forward(self, props: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        # features may arrive bf16 (misc.half_feats) or fp32; compute in the activation dtype
        x = torch.cat([props.to(self.dt), boxes.to(self.dt)], dim=-1)
        return torch.relu(linear(x, self.prop_proj))


class SegEncoder(nn.Module):
    def __init__(self, cfg, tp=None):
        super().__init__()
        self.seg_proj = nn.Linear(cfg.ds.seg_dim, cfg.mdl.vis_dim // (tp.model if tp else 1))
        self.dt = act_dtype(cfg)

    def forward(self, seg: torch.Tensor) -> torch.Tensor:
        return torch.relu(linear(seg.to(self.dt), self.seg_proj))
