"""Grounding evaluator: Acc / VAcc / Strict Acc / Cons at IoU 0.5.

Counterpart of vog_tpu/evaluation/grounding_eval.py, on tensors.  For each
considered (arg, annotated frame) pair the candidates are the P proposals
at that frame of each of the V videos, a (V, P) slice of the canonical
(B, A, V, F, P) score grid:

  Acc        the top-scoring candidate lies in the positive video and has
             IoU >= 0.5 with the GT box;
  VAcc       the top-scoring candidate lies in the positive video;
  Strict Acc per query: every considered pair is correct;
  Cons       per query: every considered pair picks the same video.

Masked proposals take -1e30 before the argmax, which takes the first
maximum (as ``jnp.argmax``).  Every step is a tensor op with no host
sync, so ``evaluate_batch`` can run inside a CUDA graph; the host only
aggregates the scalar sums (``finalize_metrics``).  Boxes are normalised
xyxy: IoU does not change under independent x/y scaling.
"""

from __future__ import annotations

from typing import Dict

import torch

IOU_THRESH = 0.5


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of broadcastable (..., 4) xyxy boxes."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (x[..., 2] - x[..., 0]).clamp(min=0) * (x[..., 3] - x[..., 1]).clamp(min=0)

    union = area(a) + area(b) - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(union))


def evaluate_batch(
    scores: torch.Tensor,  # (B,A,V,F,P) canonical logits
    prop_boxes: torch.Tensor,  # (B,V,F,P,5) normalised (unshifted)
    gt_boxes: torch.Tensor,  # (B,A,F,4) normalised
    gt_frame_mask: torch.Tensor,  # (B,A,F)
    srl_arg_mask: torch.Tensor,  # (B,A)
    pos_vid: torch.Tensor,  # (B,)
    batch_mask: torch.Tensor,  # (B,)
    prop_mask: torch.Tensor,  # (B,V,F,P) valid-proposal mask
    max_pairs: int = 0,
) -> Dict[str, torch.Tensor]:
    """-> the scalar sums and the per-pair predictions.

    ``max_pairs <= 0``: the full (B, A, F) prediction grids and the
    (B, A, F, V*P) candidate grid.  ``max_pairs > 0``: the compact form,
    the considered pairs moved to the front of a static (B, K) budget
    (K = min(max_pairs, A*F)) by a stable sort, in arg-major, frame-minor
    order; ``n_overflow`` counts the pairs beyond the budget (the sums
    always cover every pair)."""
    B, A, V, F, P = scores.shape
    considered = gt_frame_mask * srl_arg_mask[:, :, None] * batch_mask[:, None, None]  # (B,A,F)
    scores = torch.where(prop_mask[:, None] > 0, scores, torch.full_like(scores, -1e30))
    cand = scores.permute(0, 1, 3, 2, 4).reshape(B, A, F, V * P)
    choice = torch.argmax(cand, dim=-1)  # (B,A,F), the first maximum
    v_hat, p_hat = choice // P, choice % P
    f_idx = torch.arange(F, device=scores.device)[None, None, :]
    b_idx = torch.arange(B, device=scores.device)[:, None, None]
    chosen_box = prop_boxes[b_idx, v_hat, f_idx, p_hat, :4]  # (B,A,F,4)
    v_hat, p_hat = v_hat.to(torch.int32), p_hat.to(torch.int32)

    pair_iou = iou(chosen_box, gt_boxes)
    vid_ok = (v_hat == pos_vid[:, None, None]).to(torch.float32)
    acc_ok = vid_ok * (pair_iou >= IOU_THRESH).to(torch.float32)

    has_pairs = (considered.sum(dim=(1, 2)) > 0).to(torch.float32)  # (B,)
    all_correct = torch.where(considered > 0, acc_ok, torch.ones_like(acc_ok)).reshape(B, -1).amin(-1)
    vh = torch.where(considered > 0, v_hat, torch.full_like(v_hat, -1)).reshape(B, -1)
    vmax = vh.amax(-1)
    same = ((vh == vmax[:, None]) | (vh < 0)).to(torch.float32).amin(-1)
    out = {
        "n_pairs": considered.sum(),
        "n_acc": (acc_ok * considered).sum(),
        "n_vacc": (vid_ok * considered).sum(),
        "n_queries": has_pairs.sum(),
        "n_strict": (all_correct * has_pairs).sum(),
        "n_cons": (same * has_pairs).sum(),
    }
    if max_pairs <= 0:
        out.update(pred_vid=v_hat, pred_prop=p_hat, pred_iou=pair_iou, considered=considered,
                   cand_scores=cand)
        return out

    K = min(max_pairs, A * F)
    flat_cons = considered.reshape(B, A * F)
    order = torch.argsort(-flat_cons, dim=-1, stable=True)[:, :K]  # (B,K)

    def take(x):
        return torch.gather(x.reshape(B, A * F), 1, order)

    valid = take(flat_cons)
    out.update(
        pair_valid=valid,
        pair_arg=(order // F).to(torch.int32),
        pair_frame=(order % F).to(torch.int32),
        pair_vid=take(v_hat),
        pair_prop=take(p_hat),
        pair_iou=take(pair_iou),
        pair_scores=torch.gather(cand.reshape(B, A * F, V * P), 1, order[..., None].expand(B, K, V * P)),
        n_overflow=(flat_cons.sum() - valid.sum()).clamp(min=0.0),
    )
    return out


def finalize_metrics(sums: Dict[str, float]) -> Dict[str, float]:
    """Aggregated sums -> the reference metric dict."""
    np_ = max(sums["n_pairs"], 1.0)
    nq = max(sums["n_queries"], 1.0)
    return {
        "acc": sums["n_acc"] / np_,
        "vacc": sums["n_vacc"] / np_,
        "strict_acc": sums["n_strict"] / nq,
        "cons": sums["n_cons"] / nq,
        "num_pairs": sums["n_pairs"],
        "num_queries": sums["n_queries"],
    }
