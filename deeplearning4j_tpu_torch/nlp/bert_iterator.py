"""BertIterator: MLM and sequence-classification batches (port of
``deeplearning4j_tpu/nlp/bert_iterator.py``).

deeplearning4j's ``BertIterator`` with ``Task.UNSUPERVISED`` (masked-LM
batches through ``BertMaskedLMMasker``: 15% of positions, 80/10/10
mask/random/keep) and ``Task.SEQ_CLASSIFICATION``, fed by sentence
providers.  Batches are numpy dicts matching ``models.bert``'s inputs
(``input_ids``, ``token_type_ids``, ``attention_mask``, and for MLM
``labels`` and ``label_weights``, 1.0 exactly at masked positions; for
classification one-hot ``labels``), all of one static shape
[batch, seq_len], and equal to the JAX package's for one seed: the same
numpy generator draws the same masks.
"""

from __future__ import annotations

import numpy as np
from typing import Iterator, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.tokenization import BertWordPieceTokenizer, Vocabulary


class CollectionSentenceProvider:
    """In-memory sentence source (reference: CollectionSentenceProvider)."""

    def __init__(self, sentences: Sequence[str]):
        self.sentences = list(sentences)

    def __iter__(self):
        return iter(self.sentences)

    def __len__(self):
        return len(self.sentences)


class CollectionLabeledSentenceProvider:
    """Labelled sentences (reference: CollectionLabeledSentenceProvider)."""

    def __init__(self, sentences: Sequence[str], labels: Sequence[str]):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels length mismatch")
        self.sentences = list(sentences)
        self.labels = list(labels)
        self.label_set = sorted(set(self.labels))
        self.label_index = {l: i for i, l in enumerate(self.label_set)}

    def __iter__(self):
        return iter(zip(self.sentences, self.labels))

    def __len__(self):
        return len(self.sentences)

    @property
    def num_classes(self) -> int:
        return len(self.label_set)


class BertMaskedLMMasker:
    """80/10/10 MLM masking (reference: BertMaskedLMMasker).

    For each maskable position, with probability ``mask_prob`` the token
    is selected; a selected token is replaced by [MASK] 80% of the time,
    by a random vocab token 10%, kept unchanged 10%.  Special tokens
    ([CLS]/[SEP]/[PAD]) are never selected.
    """

    def __init__(self, mask_prob: float = 0.15, mask_token_prob: float = 0.8,
                 random_token_prob: float = 0.1, seed: int = 12345):
        self.mask_prob = mask_prob
        self.mask_token_prob = mask_token_prob
        self.random_token_prob = random_token_prob
        self.rng = np.random.default_rng(seed)

    def mask_sequence(self, ids: np.ndarray, vocab: Vocabulary,
                      maskable: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """→ (masked_ids, labels, label_weights); labels hold the ORIGINAL
        ids everywhere, weights are 1.0 only where masked."""
        ids = np.asarray(ids, dtype=np.int32)
        labels = ids.copy()
        out = ids.copy()
        selected = (self.rng.random(ids.shape) < self.mask_prob) & maskable
        if not selected.any() and maskable.any():
            # guarantee >=1 masked position per sequence (reference masks at
            # least one token so the loss is never vacuous)
            idx = self.rng.choice(np.flatnonzero(maskable))
            selected[idx] = True
        action = self.rng.random(ids.shape)
        mask_here = selected & (action < self.mask_token_prob)
        random_here = selected & (action >= self.mask_token_prob) & \
            (action < self.mask_token_prob + self.random_token_prob)
        out[mask_here] = vocab.mask_id
        if random_here.any():
            out[random_here] = self.rng.integers(
                0, len(vocab), size=int(random_here.sum()), dtype=np.int32)
        weights = selected.astype(np.float32)
        return out, labels, weights


class BertIterator:
    """Static-shape batch iterator over a sentence provider.

    task="unsupervised" → MLM dicts; task="seq_classification" → one-hot
    labelled dicts.  Masking follows the reference's preserved-RNG
    behavior: each epoch draws FRESH masks (epoch index folded into the
    seed), while two iterators built with the same seed replay the same
    epoch sequence — deterministic but not mask-frozen.  Pass
    ``static_masks=True`` to reuse epoch-0 masks every epoch.

    Every batch has the same static shape [batch_size, seq_len]: the
    final partial batch is padded by duplicating rows, with the returned
    ``sample_weights`` vector 0 on padding rows (MLM ``label_weights``
    are zeroed there too, so padding never contributes loss).
    """

    UNSUPERVISED = "unsupervised"
    SEQ_CLASSIFICATION = "seq_classification"

    def __init__(self, tokenizer: BertWordPieceTokenizer, provider,
                 task: str = UNSUPERVISED, seq_len: int = 128,
                 batch_size: int = 32, masker: Optional[BertMaskedLMMasker] = None,
                 seed: int = 12345, static_masks: bool = False,
                 pad_final_batch: bool = True):
        if task not in (self.UNSUPERVISED, self.SEQ_CLASSIFICATION):
            raise ValueError(f"unknown task {task!r}")
        if task == self.SEQ_CLASSIFICATION and not hasattr(provider, "num_classes"):
            raise ValueError("seq_classification needs a labelled provider")
        self.tokenizer = tokenizer
        self.vocab = tokenizer.vocab
        self.provider = provider
        self.task = task
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.static_masks = static_masks
        self.pad_final_batch = pad_final_batch
        self.masker = masker or BertMaskedLMMasker(seed=seed)
        self._epoch = 0

    # --------------------------------------------------------- encoding
    def _encode_sentence(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        """→ (ids[seq_len], attention_mask[seq_len]) with [CLS] ... [SEP]
        framing, truncation and [PAD] padding."""
        ids = self.tokenizer.encode(text)[: self.seq_len - 2]
        ids = [self.vocab.cls_id] + ids + [self.vocab.sep_id]
        n = len(ids)
        ids = ids + [self.vocab.pad_id] * (self.seq_len - n)
        mask = np.zeros(self.seq_len, dtype=np.float32)
        mask[:n] = 1.0
        return np.asarray(ids, dtype=np.int32), mask

    def _maskable(self, ids: np.ndarray, attn: np.ndarray) -> np.ndarray:
        special = (ids == self.vocab.cls_id) | (ids == self.vocab.sep_id) | \
            (ids == self.vocab.pad_id)
        return (attn > 0) & ~special

    # --------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[dict]:
        epoch = 0 if self.static_masks else self._epoch
        self.masker.rng = np.random.default_rng([self.seed, epoch])
        batch_items = []
        for item in self.provider:
            batch_items.append(item)
            if len(batch_items) == self.batch_size:
                yield self._build_batch(batch_items)
                batch_items = []
        if batch_items:
            yield self._build_batch(batch_items)

    def reset(self) -> None:
        self._epoch += 1

    def _pad_rows(self, n_real: int):
        """Row indices duplicating the batch up to batch_size + weights."""
        if not self.pad_final_batch or n_real == self.batch_size:
            idx = np.arange(n_real)
            return idx, np.ones(n_real, dtype=np.float32)
        idx = np.concatenate([np.arange(n_real),
                              np.arange(self.batch_size - n_real) % n_real])
        weights = np.zeros(self.batch_size, dtype=np.float32)
        weights[:n_real] = 1.0
        return idx, weights

    def _build_batch(self, items) -> dict:
        if self.task == self.UNSUPERVISED:
            rows = [self._encode_sentence(t) for t in items]
            ids = np.stack([r[0] for r in rows])
            attn = np.stack([r[1] for r in rows])
            masked, labels, weights = [], [], []
            for row_ids, row_attn in zip(ids, attn):
                m, l, w = self.masker.mask_sequence(
                    row_ids, self.vocab, self._maskable(row_ids, row_attn))
                masked.append(m); labels.append(l); weights.append(w)
            idx, sample_w = self._pad_rows(len(items))
            return {"input_ids": np.stack(masked)[idx],
                    "token_type_ids": np.zeros_like(ids)[idx],
                    "attention_mask": attn[idx],
                    "labels": np.stack(labels)[idx],
                    "label_weights": np.stack(weights)[idx] * sample_w[:, None],
                    "sample_weights": sample_w}
        # seq_classification
        texts = [t for t, _ in items]
        label_ids = [self.provider.label_index[l] for _, l in items]
        rows = [self._encode_sentence(t) for t in texts]
        ids = np.stack([r[0] for r in rows])
        attn = np.stack([r[1] for r in rows])
        onehot = np.eye(self.provider.num_classes, dtype=np.float32)[label_ids]
        idx, sample_w = self._pad_rows(len(items))
        return {"input_ids": ids[idx],
                "token_type_ids": np.zeros_like(ids)[idx],
                "attention_mask": attn[idx],
                "labels": onehot[idx],
                "sample_weights": sample_w}
