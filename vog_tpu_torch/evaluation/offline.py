"""Offline re-scoring of saved predictions (counterpart of
vog_tpu/evaluation/offline.py).

Reference parity: ``code/eval_fn_corr.py §eval_fun(predictions_file,
split)``.  The Learner's pickle (``tmp/predictions/{uid}_{split}_{epoch}
.pkl``, the JAX package's format) holds, for each considered (arg,
annotated frame) pair, the masked (V*P) candidate scores and the group's
positive slot; ``eval_fun`` takes the argmax again, recomputes the IoU
against the split's annotations and boxes (valid and test groups are a
fixed function of the index) and gives Acc / VAcc / Strict / Cons as the
on-device evaluator does.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict

import numpy as np

from vog_tpu_torch.evaluation.grounding_eval import IOU_THRESH, finalize_metrics


def _iou_np(a: np.ndarray, b: np.ndarray) -> float:
    """Same formula and order as ``grounding_eval.iou``, fp32 numpy."""
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[0] * wh[1]

    def area(x):
        return max(x[2] - x[0], 0.0) * max(x[3] - x[1], 0.0)

    union = np.float32(area(a)) + np.float32(area(b)) - inter
    return float(inter / max(union, np.float32(1e-12))) if union > 0 else 0.0


def eval_fun(pred_file: str | Path, split: str, cfg) -> Dict[str, float]:
    """Re-score a predictions pickle -> the reference metric dict.

    Reconstructs each query's (deterministic) eval group from the split's
    dataset to look up proposal and GT boxes; everything else comes from
    the file.  Metric definitions match ``grounding_eval.evaluate_batch``.
    """
    from vog_tpu_torch.data.dataset import AnetSRLDataset, get_vocab
    from vog_tpu_torch.data.featpack import open_store

    ds = AnetSRLDataset(cfg, split, get_vocab(cfg), open_store(cfg.ds.data_dir))
    if ds.sampler.is_train:
        raise ValueError(
            "offline re-scoring needs deterministic contrastive groups; "
            "the train split samples random partners per epoch — re-score "
            "valid/test predictions instead"
        )

    with open(pred_file, "rb") as f:
        preds = pickle.load(f)

    sums = {k: 0.0 for k in (
        "n_pairs", "n_acc", "n_vacc", "n_queries", "n_strict", "n_cons"
    )}
    for rec in preds:
        item = ds.__getitem__(int(rec["ann_idx"]))
        P = int(rec["num_props"])
        pos_vid = int(rec["pos_vid"])
        pairs = list(zip(rec["arg_idx"], rec["frame_idx"], rec["scores"]))
        if not pairs:
            continue
        sums["n_queries"] += 1
        all_ok = True
        picked_vids = []
        for a, fr, scores_vp in pairs:
            choice = int(np.argmax(np.asarray(scores_vp, np.float32)))
            v, p = choice // P, choice % P
            box = item["prop_boxes"][v, fr, p, :4]
            gt = item["gt_boxes"][a, fr]
            iou = _iou_np(box, gt)
            vid_ok = v == pos_vid
            ok = vid_ok and iou >= IOU_THRESH
            sums["n_pairs"] += 1
            sums["n_vacc"] += float(vid_ok)
            sums["n_acc"] += float(ok)
            all_ok &= ok
            picked_vids.append(v)
        sums["n_strict"] += float(all_ok)
        sums["n_cons"] += float(len(set(picked_vids)) == 1)
    return finalize_metrics(sums)
