"""deeplearning4j_tpu_torch — the PyTorch + CUDA port of deeplearning4j_tpu
for NVIDIA Hopper GPUs.

It mirrors the JAX package's module paths and JSON configs, keeps its
tensor layouts (NHWC activations, HWIO conv kernels, dense ``W [nIn,
nOut]``) and imports nothing of it.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``, and raise when the card is
absent.  Where the JAX package runs a Pallas TPU kernel, the port runs a
CUDA kernel written for ``sm_90a`` (``ops/kernels/csrc``), built with
``nvcc`` at first use.
"""

__version__ = "0.1.0"
