from deeplearning4j_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from deeplearning4j_tpu_torch.models.zoo import resnet50

__all__ = ["resnet50", "BertConfig", "BertForMaskedLM"]
