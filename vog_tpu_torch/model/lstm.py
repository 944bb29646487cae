"""Bidirectional LSTM with torch packed-sequence semantics, no host sync.

Counterpart of vog_tpu/model/lstm.py.  The contract (as there):

  * gate order i, f, g, o; both biases b_ih + b_hh added;
  * outputs beyond a sample's length are zeros, the reverse direction
    starts at the sample's actual last token, and the final states are
    taken at each sample's length (a length of 0 gives zeros).

Each direction is one unidirectional ``nn.LSTM`` (``fwd``, ``bwd``; the
JAX package stores the weights transposed, (in, 4H)) run on the padded
batch: the forward direction's outputs before a sample's length do not
depend on the padding, and the reverse direction runs on each sequence
reversed within its length, as the JAX scan does.  This gives the
packed-sequence result without ``pack_padded_sequence``, whose lengths
must be on the host and whose index copy synchronises the stream, which
would serialise the pipelined serving loop.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence (B,L,D) within its valid length."""
    B, L = x.shape[0], x.shape[1]
    t = torch.arange(L, device=x.device)[None, :]
    idx = (lengths[:, None] - 1 - t).clamp(0, L - 1)  # (B, L)
    return torch.gather(x, 1, idx[:, :, None].expand(B, L, x.shape[-1]))


def _at_length(y: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """y[b, len_b - 1], zeros where len_b == 0."""
    B = y.shape[0]
    last = (lengths - 1).clamp(min=0)
    h = y[torch.arange(B, device=y.device), last]
    return h * (lengths > 0)[:, None].to(y.dtype)


class TorchBiLSTM(nn.Module):
    """Single-layer bidirectional LSTM; returns (outputs (B,L,2H),
    h_n (B,2H)), h_n being the forward state at each sample's last token
    beside the reverse state after its first (torch's h_n per direction).
    No model reads the cell state, so it is not returned."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.fwd = nn.LSTM(input_size, hidden, batch_first=True)
        self.bwd = nn.LSTM(input_size, hidden, batch_first=True)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        B, L, _ = x.shape
        lengths = lengths.long()
        mask = (torch.arange(L, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)

        y_f = self.fwd(x)[0] * mask[:, :, None]
        y_b_rev = self.bwd(_reverse_padded(x, lengths))[0]
        h_f, h_b = _at_length(y_f, lengths), _at_length(y_b_rev, lengths)
        y_b = _reverse_padded(y_b_rev, lengths) * mask[:, :, None]

        y = torch.cat([y_f, y_b], dim=-1)
        h_n = torch.cat([h_f, h_b], dim=-1)
        return y, h_n
