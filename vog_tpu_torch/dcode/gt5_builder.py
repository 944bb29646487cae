"""GT5 proposal-set builder (counterpart of vog_tpu/dcode/gt5_builder.py).

For each frame of each video segment, the 5-proposal set is built from
the P100 detections: the proposal(s) that overlap a GT box (IoU >= 0.5)
are kept (so the oracle grounding accuracy is high), and the remaining
slots are filled with the top-scoring detections.  This turns a P100
store into a GT5 one.

Usage:
  python -m vog_tpu_torch.dcode.gt5_builder <p100_dir> <out_dir> [num_props]

<p100_dir> holds a feature store (the pack, or the h5 form where h5py is
installed: ``data/featpack.py §open_store``), anns_{split}.jsonl and
vid_dims.json.  The GT5 store is written as a pack (``PackWriter``): the
selected feats, boxes and scores of each frame, and the segment features
unchanged, so the arrays equal the JAX package's ``roi_feats.h5`` (and
its ``seg_feats/``) bitwise.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

from vog_tpu_torch.data.boxes import iou_matrix
from vog_tpu_torch.data.featpack import PackWriter, open_store
from vog_tpu_torch.data.vocab import load_annotations

IOU_THRESH = 0.5


def gt5_select(
    boxes: np.ndarray,  # (P, 4) detections in one frame
    scores: np.ndarray,  # (P,)
    gt_boxes: List[np.ndarray],  # GT boxes annotated in this frame
    k: int = 5,
) -> np.ndarray:
    """Indices of the k selected proposals: GT-overlapping first (best IoU
    per GT), then top-scoring detections."""
    chosen: List[int] = []
    if gt_boxes:
        ious = iou_matrix(boxes, np.stack(gt_boxes))  # (P, G)
        for g in range(ious.shape[1]):
            best = int(np.argmax(ious[:, g]))
            if ious[best, g] >= IOU_THRESH and best not in chosen:
                chosen.append(best)
                if len(chosen) >= k:
                    break
    order = np.argsort(-scores)
    for p in order:
        if len(chosen) >= k:
            break
        if int(p) not in chosen:
            chosen.append(int(p))
    while len(chosen) < k:  # degenerate tiny-P case: repeat best
        chosen.append(chosen[-1] if chosen else 0)
    return np.asarray(chosen[:k], np.int64)


def _feat_shapes(store, vid: str) -> tuple:
    """-> (feats shape, seg shape) of one video: the pack's entries, or
    the arrays of the h5 form."""
    entries = getattr(store, "entries", None)
    if entries is not None:
        return tuple(entries[vid]["feats"][1]), tuple(entries[vid]["seg"][1])
    feats, seg = store.get_feats(vid)
    return feats.shape, seg.shape


def build_gt5(p100_dir: str | Path, out_dir: str | Path, k: int = 5) -> Path:
    p100_dir, out_dir = Path(p100_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # GT boxes per (vid_seg, frame) from all splits' annotations
    gt_by_seg: Dict[str, Dict[int, List[np.ndarray]]] = {}
    for split in ("train", "valid", "test"):
        f = p100_dir / f"anns_{split}.jsonl"
        if not f.exists():
            continue
        for ann in load_annotations(f):
            seg = gt_by_seg.setdefault(ann["vid_seg"], {})
            for arg in ann["args"]:
                for bx in arg["boxes"]:
                    seg.setdefault(int(bx["frame"]), []).append(
                        np.asarray(bx["box"], np.float32)
                    )
        shutil.copy(f, out_dir / f.name)
        cs = p100_dir / f"cs_dict_{split}.json"
        if cs.exists():
            shutil.copy(cs, out_dir / cs.name)

    # pass 1: each frame's selection (the small fields) and the pack's shapes
    store = open_store(p100_dir)
    picks: Dict[str, np.ndarray] = {}
    shapes: Dict[str, Dict[str, tuple]] = {}
    for seg in store.videos():
        boxes, scores = store.get_meta(seg)
        gts = gt_by_seg.get(seg, {})
        picks[seg] = np.stack([gt5_select(boxes[fr], scores[fr], gts.get(fr, []), k)
                               for fr in range(boxes.shape[0])]).reshape(boxes.shape[0], k)
        F = boxes.shape[0]
        feats_shape, seg_shape = _feat_shapes(store, seg)
        shapes[seg] = {"feats": (F, k, feats_shape[-1]), "boxes": (F, k, 4), "scores": (F, k),
                       "seg": seg_shape}
    # pass 2: the selected rows, a video at a time
    writer = PackWriter(out_dir, shapes)
    for seg, idx in picks.items():
        feats, boxes, scores, seg_feats = store.get(seg)
        writer.put(seg, feats=np.take_along_axis(feats, idx[..., None], 1),
                   boxes=np.take_along_axis(boxes, idx[..., None], 1),
                   scores=np.take_along_axis(scores, idx, 1), seg=seg_feats)
    writer.close()

    shutil.copy(p100_dir / "vid_dims.json", out_dir / "vid_dims.json")
    if (p100_dir / "glove.txt").exists():
        shutil.copy(p100_dir / "glove.txt", out_dir / "glove.txt")
    return out_dir


if __name__ == "__main__":
    src, dst = sys.argv[1], sys.argv[2]
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    build_gt5(src, dst, k)
    print(f"gt5 dataset written to {dst}")
