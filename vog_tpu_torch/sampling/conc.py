"""Contrastive concatenation (SVSQ / SEP / TEMP / SPAT) on tensors.

Counterpart of vog_tpu/sampling/conc.py.  The stacked group layout
``(B, V, F, P, ...)`` becomes the unified clip view every model consumes:

  props (B',T,D)  boxes (B',T,5)  mask (B',T)  seg (B',F',seg_dim)
  frame_ids (T,) int64   token -> frame index (temporal PE / RPE)

plus language tensors tiled to B' and targets flattened to (B',A,T).
Only reshapes, transposes, one add (the SPAT x-shift) and one mean (the
SPAT per-frame segment feature), so the result is bitwise equal to the
JAX package's.

``scores_to_canonical`` maps logits (B',A,T) back to (B,A,V,F,P).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

LANG_KEYS = ("tokens", "seq_len", "verb_idx", "srl_roles", "srl_spans", "srl_arg_mask")


def view_dims(conc_type: str, V: int, F: int, P: int) -> Tuple[int, int, int]:
    """-> (B_mult, F', P') of the clip view."""
    if conc_type == "svsq":
        return 1, F, P
    if conc_type == "sep":
        return V, F, P
    if conc_type == "temp":
        return 1, V * F, P
    if conc_type == "spat":
        return 1, F, V * P
    raise ValueError(conc_type)


def frame_ids(conc_type: str, V: int, F: int, P: int, device=None) -> torch.Tensor:
    """Per-token frame index in the clip view."""
    _, Fp, Pp = view_dims(conc_type, V, F, P)
    return torch.arange(Fp, device=device).repeat_interleave(Pp)


def video_ids(conc_type: str, V: int, F: int, P: int, device=None) -> torch.Tensor:
    """Per-token source-video slot in the clip view."""
    if conc_type in ("svsq", "sep"):  # sep folds the video axis into batch
        return torch.zeros(F * P, dtype=torch.int64, device=device)
    if conc_type == "temp":
        return torch.arange(V * F * P, device=device) // (F * P)
    if conc_type == "spat":
        t = torch.arange(F * V * P, device=device)
        return (t % (V * P)) // P
    raise ValueError(conc_type)


def _spat_shift_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Shift x1/x2 by the video slot: boxes (B,V,F,P,5) -> shifted copy."""
    V = boxes.shape[1]
    shift = torch.arange(V, dtype=boxes.dtype, device=boxes.device).reshape(1, V, 1, 1)
    out = boxes.clone()
    out[..., 0] += shift
    out[..., 2] += shift
    return out


def assemble_batch(batch: Dict[str, torch.Tensor], conc_type: str) -> Dict[str, torch.Tensor]:
    """Fuse the stacked (B,V,...) group into the clip view."""
    props, boxes = batch["props"], batch["prop_boxes"]
    pmask, seg = batch["prop_mask"], batch["seg_feats"]
    B, V, F, P, D = props.shape
    has_t = "targets" in batch
    out: Dict[str, torch.Tensor] = {}

    if conc_type == "svsq":
        assert V == 1
        out["props"] = props.reshape(B, F * P, D)
        out["boxes"] = boxes.reshape(B, F * P, 5)
        out["mask"] = pmask.reshape(B, F * P)
        out["seg"] = seg.reshape(B, F, -1)
        if has_t:
            t = batch["targets"]
            out["targets"] = t.reshape(B, t.shape[2], F * P)
        for k in LANG_KEYS:
            out[k] = batch[k]
        out["batch_mask"] = batch["batch_mask"]
    elif conc_type == "sep":
        out["props"] = props.reshape(B * V, F * P, D)
        out["boxes"] = boxes.reshape(B * V, F * P, 5)
        out["mask"] = pmask.reshape(B * V, F * P)
        out["seg"] = seg.reshape(B * V, F, -1)
        if has_t:
            t = batch["targets"]
            out["targets"] = t.reshape(B * V, t.shape[2], F * P)
        for k in LANG_KEYS:
            out[k] = batch[k].repeat_interleave(V, dim=0)
        out["batch_mask"] = batch["batch_mask"].repeat_interleave(V, dim=0)
    elif conc_type == "temp":
        out["props"] = props.reshape(B, V * F * P, D)
        out["boxes"] = boxes.reshape(B, V * F * P, 5)
        out["mask"] = pmask.reshape(B, V * F * P)
        out["seg"] = seg.reshape(B, V * F, -1)
        if has_t:
            t = batch["targets"]  # (B,V,A,F,P) -> (B,A,V*F*P)
            out["targets"] = t.permute(0, 2, 1, 3, 4).reshape(B, t.shape[2], V * F * P)
        for k in LANG_KEYS:
            out[k] = batch[k]
        out["batch_mask"] = batch["batch_mask"]
    elif conc_type == "spat":
        sboxes = _spat_shift_boxes(boxes)
        # (B,V,F,P,...) -> (B,F,V,P,...) -> (B, F*V*P, ...)
        out["props"] = props.permute(0, 2, 1, 3, 4).reshape(B, F * V * P, D)
        out["boxes"] = sboxes.permute(0, 2, 1, 3, 4).reshape(B, F * V * P, 5)
        out["mask"] = pmask.permute(0, 2, 1, 3).reshape(B, F * V * P)
        out["seg"] = seg.mean(dim=1)  # per-frame segment feature: mean over videos
        if has_t:
            t = batch["targets"]
            out["targets"] = t.permute(0, 2, 3, 1, 4).reshape(B, t.shape[2], F * V * P)
        for k in LANG_KEYS:
            out[k] = batch[k]
        out["batch_mask"] = batch["batch_mask"]
    else:
        raise ValueError(conc_type)

    out["frame_ids"] = frame_ids(conc_type, V, F, P, device=props.device)
    out["video_ids"] = video_ids(conc_type, V, F, P, device=props.device)
    return out


def scores_to_canonical(
    scores: torch.Tensor, conc_type: str, B: int, V: int, F: int, P: int
) -> torch.Tensor:
    """Model logits (B',A,T) -> canonical (B,A,V,F,P)."""
    A = scores.shape[1]
    if conc_type == "svsq":
        return scores.reshape(B, A, 1, F, P)
    if conc_type == "sep":
        return scores.reshape(B, V, A, F, P).permute(0, 2, 1, 3, 4)
    if conc_type == "temp":
        return scores.reshape(B, A, V, F, P)
    if conc_type == "spat":
        return scores.reshape(B, A, F, V, P).permute(0, 1, 3, 2, 4)
    raise ValueError(conc_type)
