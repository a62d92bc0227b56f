"""Closed-loop continual learning (port of ``deeplearning4j_tpu/online``):

    serve traffic → feedback spool → replay source → background
    fine-tune (health-guarded, exact-resume) → eval gate →
    verified hot-swap → post-deploy watch → automatic rollback

- :class:`FeedbackSource`: the spool as a resumable training stream.
- :class:`OnlineTrainer`: the background fine-tune loop.
- :class:`EvalGate` / :class:`GatedDeployer` / :class:`DeployWatch`:
  candidate-vs-incumbent scoring, deploy only on non-regression, and
  rollback when live serve metrics regress.
"""

from deeplearning4j_tpu_torch.online.gate import (DeployWatch, EvalGate, GateDecision,
                                                  GatedDeployer)
from deeplearning4j_tpu_torch.online.loop import OnlineConfig, OnlineTrainer
from deeplearning4j_tpu_torch.online.source import FeedbackSource

__all__ = [
    "DeployWatch", "EvalGate", "FeedbackSource", "GateDecision",
    "GatedDeployer", "OnlineConfig", "OnlineTrainer",
]
