"""Training: the single-device trainer and the updaters."""

from deeplearning4j_tpu_torch.train.trainer import Trainer, make_loss_fn
from deeplearning4j_tpu_torch.train.updaters import Adam, Nesterovs, NoOp, Sgd

__all__ = ["Trainer", "make_loss_fn", "Sgd", "Nesterovs", "Adam", "NoOp"]
