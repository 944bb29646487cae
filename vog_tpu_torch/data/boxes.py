"""Box utilities of the host data path (copy of vog_tpu/data/boxes.py):
pairwise IoU, and the 5-d normalised proposal box ``(x1, y1, x2, y2,
area)`` by the frame's width and height.  The evaluator's tensor twin is
``evaluation/grounding_eval.py §iou``.
"""

from __future__ import annotations

import numpy as np


def box_area(boxes: np.ndarray) -> np.ndarray:
    """Area of [x1,y1,x2,y2] boxes; clamps degenerate boxes to 0."""
    w = np.clip(boxes[..., 2] - boxes[..., 0], 0, None)
    h = np.clip(boxes[..., 3] - boxes[..., 1], 0, None)
    return w * h


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU between a (N,4) and b (M,4) -> (N,M)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def iou_single(a: np.ndarray, b: np.ndarray) -> float:
    return float(iou_matrix(a[None], b[None])[0, 0])


def normalize_boxes(boxes: np.ndarray, w: float, h: float) -> np.ndarray:
    """(…,4) absolute -> (…,5) normalized (x1,y1,x2,y2,area).

    Reference parity: the 5-d normalized box feature concatenated to the
    RoI fc6 feature (``code/dat_loader_simple.py``; 5th dim = relative
    area).
    """
    boxes = np.asarray(boxes, np.float32)
    out = np.empty(boxes.shape[:-1] + (5,), np.float32)
    out[..., 0] = boxes[..., 0] / w
    out[..., 1] = boxes[..., 1] / h
    out[..., 2] = boxes[..., 2] / w
    out[..., 3] = boxes[..., 3] / h
    out[..., 4] = (
        np.clip(boxes[..., 2] - boxes[..., 0], 0, None)
        * np.clip(boxes[..., 3] - boxes[..., 1], 0, None)
        / (w * h)
    )
    return out
