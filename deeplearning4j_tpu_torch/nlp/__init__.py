"""NLP: wordpiece tokenization and the BERT batch pipeline."""

from deeplearning4j_tpu_torch.nlp.bert_iterator import (
    BertIterator, BertMaskedLMMasker, CollectionLabeledSentenceProvider,
    CollectionSentenceProvider)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    BasicTokenizer, BertWordPieceTokenizer, Vocabulary, WordpieceTokenizer, build_vocab)

__all__ = ["BasicTokenizer", "WordpieceTokenizer", "BertWordPieceTokenizer", "Vocabulary",
           "build_vocab", "BertIterator", "BertMaskedLMMasker", "CollectionSentenceProvider",
           "CollectionLabeledSentenceProvider"]
