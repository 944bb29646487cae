"""Losses (counterpart of vog_tpu/model/loss.py and
vog_tpu/model/grounding.py §compute_loss).

Masked sigmoid BCE per (arg, proposal) against the IoU >= 0.5 targets,
averaged over the valid entries, with an optional positive-class weight;
and the listwise rank loss over each arg's candidates, with SEP's
``num_cmp`` videos re-joined along the candidate axis.  Both run in fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn


def masked_bce_loss(
    logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor, pos_weight: float = 1.0
) -> torch.Tensor:
    """Sigmoid BCE averaged over the mask > 0 entries; ``pos_weight``
    scales the positive entries' terms."""
    s, n = _bce_terms(logits, targets, mask, pos_weight)
    return s / n.clamp(min=1.0)


def _bce_terms(logits, targets, mask, pos_weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (the masked sum of the BCE terms, the count of the mask)."""
    per = -targets * Fn.logsigmoid(logits) - (1.0 - targets) * Fn.logsigmoid(-logits)
    if pos_weight != 1.0:
        per = per * torch.where(targets > 0, pos_weight, 1.0)
    return (per * mask).sum(), mask.sum()


def masked_rank_loss(
    logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor, num_cmp: int = 1
) -> torch.Tensor:
    """Softmax cross-entropy over each arg's candidate axis with the
    positives as a normalised soft target, averaged over the args that
    have a positive.  logits/targets/mask (B', A, T); for SEP pass
    ``num_cmp=V`` so the V videos folded into the batch axis are re-joined
    to (B, A, V*T) first."""
    s, n = _rank_terms(logits, targets, mask, num_cmp)
    return s / n.clamp(min=1.0)


def _rank_terms(logits, targets, mask, num_cmp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (the sum of the per-arg cross-entropies over the args with a
    positive, their count)."""
    if num_cmp > 1:
        Bp, A, T = logits.shape
        B = Bp // num_cmp

        def regroup(x):
            return x.reshape(B, num_cmp, A, T).transpose(1, 2).reshape(B, A, num_cmp * T)

        logits, targets, mask = regroup(logits), regroup(targets), regroup(mask)
    masked = torch.where(mask > 0, logits, torch.full_like(logits, -1e30))
    logp = torch.log_softmax(masked, dim=-1)
    pos = targets * mask
    pos_count = pos.sum(-1)
    soft = pos / pos_count.clamp(min=1.0)[..., None]
    per_arg = -(soft * logp).sum(-1)
    has_pos = (pos_count > 0).to(logits.dtype)
    return (per_arg * has_pos).sum(), has_pos.sum()


def compute_loss(
    logits: torch.Tensor,
    clip: Dict,
    pos_weight: float = 1.0,
    loss_type: str = "bce",
    rank_weight: float = 1.0,
    rank_num_cmp: int = 1,
    reduce_counts: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Masked BCE over srl_arg_mask x mask x batch_mask, plus the rank term
    when ``loss_type == "rank"`` -> (loss, {"loss": loss}).

    ``reduce_counts`` (data parallelism, train/dist.py): a function that
    sums a vector of counts over the ranks.  Each term's denominator is
    then the global batch's count, and the loss this rank's share of the
    global batch's masked mean, which the JAX step takes: the shares sum
    to it over the ranks, and so do their gradients."""
    logits = logits.float()
    mask = (
        clip["srl_arg_mask"][:, :, None]
        * clip["mask"][:, None, :]
        * clip["batch_mask"][:, None, None]
    )
    terms = [_bce_terms(logits, clip["targets"], mask, pos_weight)]
    if loss_type == "rank":
        terms.append(_rank_terms(logits, clip["targets"], mask, rank_num_cmp))
    counts = [n for _, n in terms]
    if reduce_counts is not None:
        counts = list(reduce_counts(torch.stack(counts)))
    loss = terms[0][0] / counts[0].clamp(min=1.0)
    if loss_type == "rank":
        loss = loss + rank_weight * (terms[1][0] / counts[1].clamp(min=1.0))
    return loss, {"loss": loss}
