from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import activations, weights, layers

__all__ = ["InputType", "NeuralNetConfiguration", "activations", "weights", "layers"]
