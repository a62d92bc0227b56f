"""Training: the single-device trainer, its step and step cache, the
updaters and schedules, and early stopping."""

from deeplearning4j_tpu_torch.train import schedules, step_cache
from deeplearning4j_tpu_torch.train.schedules import (
    CycleSchedule, ExponentialSchedule, FixedSchedule, InverseSchedule, MapSchedule,
    PolySchedule, RampSchedule, SigmoidSchedule, StepSchedule,
)
from deeplearning4j_tpu_torch.train.trainer import (
    Trainer, make_loss_fn, make_train_step, net_optimizer,
)
from deeplearning4j_tpu_torch.train.updaters import (
    AdaDelta, AdaGrad, AdaMax, Adam, AdamW, AMSGrad, Nadam, Nesterovs, NoOp, Optimizer,
    RmsProp, Sgd,
)

__all__ = ["schedules", "step_cache", "Trainer", "make_train_step", "make_loss_fn",
           "net_optimizer", "Optimizer", "Sgd", "Nesterovs", "Adam", "AdamW", "AdaMax",
           "AMSGrad", "Nadam", "AdaGrad", "AdaDelta", "RmsProp", "NoOp", "FixedSchedule",
           "ExponentialSchedule", "InverseSchedule", "PolySchedule", "SigmoidSchedule",
           "StepSchedule", "MapSchedule", "CycleSchedule", "RampSchedule"]
