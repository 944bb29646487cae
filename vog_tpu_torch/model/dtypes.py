"""Activation-dtype policy (cfg.mdl.dtype), counterpart of
vog_tpu/model/dtypes.py.

One switch: "float32" (the parity default) or "bfloat16" (the production
recipe's mixed precision, ``configs/gt5_production.yml``).  What stays
fp32 under bf16, the numerics-sensitive set:

  * the parameters and the optimizer state: every module keeps fp32
    parameters and casts them to the activation dtype per call, as flax's
    ``dtype=`` casts them (``linear``), so autograd through the casts
    gives fp32 gradients and the flat moments stay fp32;
  * the BiLSTM language encoder (small: L of about 20 tokens); only the
    arg rep it hands to the visual fusion is cast to the activation dtype;
  * attention logits and softmax statistics: the kernels take fp32
    operands and keep fp32 scores, row maxima and sums, and the
    decomposed layer's per-arg key term c (and cn) is fp32;
  * the kernels' operands: the attention, mm attention and head call
    sites cast their operands to fp32 and the result back to the
    activation dtype (the head's logits stay fp32);
  * LayerNorm statistics (computed in fp32, the result stored in the
    activation dtype, as flax's LayerNorm);
  * the logits and the loss: every head returns fp32 logits and
    ``compute_loss`` upcasts on entry.

Everything else, every Dense, LayerNorm output, FFN and fusion
intermediate of the visual and multimodal path, computes and stores in
the activation dtype.  ``misc.matmul_precision`` is the other half of the
production numerics: "default" runs fp32 products as one TF32 pass
(``config.apply_matmul_precision``, ``config.kernel_precision``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as Fn


def act_dtype(cfg) -> torch.dtype:
    """The activation dtype the model computes in (params stay fp32)."""
    return torch.bfloat16 if cfg.mdl.dtype == "bfloat16" else torch.float32


def linear(x: torch.Tensor, lin: nn.Linear, dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lin`` applied in ``dt`` (default: x's dtype): the fp32 weight and
    bias cast per call, as flax's ``nn.Dense(dtype=dt)``; in the weight's
    own dtype this is the module's call ``lin(x)`` (its hooks run)."""
    dt = x.dtype if dt is None else dt
    if dt == lin.weight.dtype:
        return lin(x.to(dt))
    b = None if lin.bias is None else lin.bias.to(dt)
    return Fn.linear(x.to(dt), lin.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose statistics and affine run in fp32 on any
    input and whose result takes the input's dtype, as flax's
    ``nn.LayerNorm(dtype=dt)``: a bf16 input gives a bf16 output and the
    layer's fp32 parameters are not cast.  Identical to ``nn.LayerNorm``
    on fp32 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = Fn.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)
