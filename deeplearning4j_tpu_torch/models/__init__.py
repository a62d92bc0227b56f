from deeplearning4j_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from deeplearning4j_tpu_torch.models.zoo import (
    alexnet, lenet, lstm_classifier, mlp_mnist, resnet50, simple_cnn, text_gen_lstm, vgg16,
    vgg19,
)

__all__ = ["mlp_mnist", "lenet", "simple_cnn", "alexnet", "resnet50", "vgg16", "vgg19",
           "lstm_classifier", "text_gen_lstm",
           "BertConfig", "BertForMaskedLM"]
