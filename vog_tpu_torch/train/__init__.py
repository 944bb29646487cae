"""Training: the optimizer, the non-finite guard and the train step."""

from vog_tpu_torch.train.state import TrainState, make_optimizer, make_train_step

__all__ = ["TrainState", "make_optimizer", "make_train_step"]
