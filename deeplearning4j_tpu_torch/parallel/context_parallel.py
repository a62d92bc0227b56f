"""Not ported yet: the JAX package's ``parallel/context_parallel.py`` (importing this
raises ``ImportError``)."""

from deeplearning4j_tpu_torch.parallel import not_ported

not_ported(__name__)
