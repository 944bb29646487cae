"""Activation-dtype policy (cfg.mdl.dtype), counterpart of
vog_tpu/model/dtypes.py.

"float32" (parity default) or "bfloat16".  The serving and training
paths of this package run fp32 activations; the bf16 policy (what stays
fp32: params, the BiLSTM, softmax statistics, logits, kernel operands) is
wired in a later slice.
"""

from __future__ import annotations

import torch


def act_dtype(cfg) -> torch.dtype:
    """The activation dtype the model computes in (params stay fp32)."""
    return torch.bfloat16 if cfg.mdl.dtype == "bfloat16" else torch.float32
