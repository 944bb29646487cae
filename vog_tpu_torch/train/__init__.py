"""Training: the optimizer, the non-finite guard, the train and eval steps
and their fused multi-step dispatches; the Learner (``train/learner.py``)
runs them over a dataset."""

from vog_tpu_torch.train.state import (
    TrainState,
    dispatch_sizes,
    make_eval_step,
    make_multi_eval_step,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "TrainState",
    "dispatch_sizes",
    "make_eval_step",
    "make_multi_eval_step",
    "make_multi_train_step",
    "make_optimizer",
    "make_train_step",
]
