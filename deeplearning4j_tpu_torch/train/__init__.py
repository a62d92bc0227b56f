"""Training: the single-device trainer, its step and step cache, and the
updaters."""

from deeplearning4j_tpu_torch.train import step_cache
from deeplearning4j_tpu_torch.train.trainer import Trainer, make_loss_fn, make_train_step
from deeplearning4j_tpu_torch.train.updaters import Adam, Nesterovs, NoOp, Sgd

__all__ = ["step_cache", "Trainer", "make_train_step", "make_loss_fn", "Sgd", "Nesterovs",
           "Adam", "NoOp"]
