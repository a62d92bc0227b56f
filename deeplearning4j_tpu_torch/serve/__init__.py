from deeplearning4j_tpu_torch.serve.engine import (
    DeadlineExceeded,
    EngineClosed,
    InferenceEngine,
    Overloaded,
)

__all__ = ["InferenceEngine", "Overloaded", "DeadlineExceeded", "EngineClosed"]
