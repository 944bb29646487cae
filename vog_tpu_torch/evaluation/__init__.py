"""Evaluation: Acc / VAcc / Strict / Cons on the device."""

from vog_tpu_torch.evaluation.grounding_eval import IOU_THRESH, evaluate_batch, finalize_metrics, iou

__all__ = ["IOU_THRESH", "evaluate_batch", "finalize_metrics", "iou"]
