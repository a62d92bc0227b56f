"""Wordpiece tokenization for BERT (port of
``deeplearning4j_tpu/nlp/tokenization.py``, pure Python, kept as the
port's own copy).

The google-research BERT scheme, as deeplearning4j-nlp's
``BertWordPieceTokenizer`` implements it: a basic tokenizer (whitespace
and punctuation split, optional lower-casing and accent stripping, CJK
characters isolated), then greedy longest-match-first wordpiece
splitting with ``##`` continuation prefixes and an ``[UNK]`` fallback.
Host-side ETL: nothing here touches a tensor.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, Sequence


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges are treated as punctuation (BERT rule:
    # includes chars like ^ $ ` that Unicode doesn't class as P*)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Whitespace/punctuation tokenizer with BERT's cleaning rules."""

    def __init__(self, lower_case: bool = True):
        self.lower_case = lower_case

    def tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: list[str] = []
        for tok in text.split():
            if self.lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_punct(tok))
        return tokens

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(tok: str) -> list[str]:
        pieces: list[str] = []
        current: list[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces


class Vocabulary:
    """token ↔ id table (BERT ``vocab.txt`` order = ids)."""

    PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"

    def __init__(self, tokens: Sequence[str]):
        self.tokens = list(tokens)
        self.index = {t: i for i, t in enumerate(self.tokens)}
        for special in (self.PAD, self.UNK, self.CLS, self.SEP, self.MASK):
            if special not in self.index:
                raise ValueError(f"vocabulary missing special token {special}")

    def __len__(self) -> int:
        return len(self.tokens)

    def __contains__(self, token: str) -> bool:
        return token in self.index

    def id(self, token: str) -> int:
        return self.index.get(token, self.index[self.UNK])

    def ids(self, tokens: Iterable[str]) -> list[int]:
        return [self.id(t) for t in tokens]

    def token(self, idx: int) -> str:
        return self.tokens[idx]

    @property
    def pad_id(self) -> int: return self.index[self.PAD]
    @property
    def unk_id(self) -> int: return self.index[self.UNK]
    @property
    def cls_id(self) -> int: return self.index[self.CLS]
    @property
    def sep_id(self) -> int: return self.index[self.SEP]
    @property
    def mask_id(self) -> int: return self.index[self.MASK]

    @staticmethod
    def from_file(path: str) -> "Vocabulary":
        """Load a BERT ``vocab.txt`` (one token per line, line no = id).
        Every line is kept — including whitespace-only tokens — so ids
        stay aligned with line numbers; only the trailing newline-created
        empty line is dropped.  CRLF files are handled."""
        with open(path, encoding="utf-8") as f:
            tokens = [line.rstrip("\r\n") for line in f]
        if tokens and tokens[-1] == "":
            tokens.pop()
        return Vocabulary(tokens)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for t in self.tokens:
                f.write(t + "\n")


class WordpieceTokenizer:
    """Greedy longest-match-first subword splitting with ``##`` prefixes."""

    def __init__(self, vocab: Vocabulary, max_chars_per_word: int = 200):
        self.vocab = vocab
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, token: str) -> list[str]:
        if len(token) > self.max_chars_per_word:
            return [Vocabulary.UNK]
        pieces: list[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [Vocabulary.UNK]  # whole word becomes UNK (BERT rule)
            pieces.append(piece)
            start = end
        return pieces


class BertWordPieceTokenizer:
    """Full pipeline: basic tokenize → wordpiece split → ids."""

    def __init__(self, vocab: Vocabulary, lower_case: bool = True):
        self.vocab = vocab
        self.basic = BasicTokenizer(lower_case=lower_case)
        self.wordpiece = WordpieceTokenizer(vocab)

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def encode(self, text: str) -> list[int]:
        return self.vocab.ids(self.tokenize(text))


def build_vocab(corpus: Iterable[str], max_size: int = 30000,
                lower_case: bool = True, min_count: int = 1) -> Vocabulary:
    """Build a wordpiece-compatible vocabulary from a corpus: specials,
    then all single characters seen, then whole words by frequency.

    A deliberately simple scheme (no BPE merges learned) — enough to make
    the tokenizer/iterator/fine-tune pipeline end-to-end and hermetic in
    tests; real deployments load google-research ``vocab.txt`` files via
    :meth:`Vocabulary.from_file`.
    """
    basic = BasicTokenizer(lower_case=lower_case)
    counts: dict[str, int] = {}
    chars: set[str] = set()
    for text in corpus:
        for word in basic.tokenize(text):
            counts[word] = counts.get(word, 0) + 1
            chars.update(word)
    tokens = [Vocabulary.PAD, Vocabulary.UNK, Vocabulary.CLS,
              Vocabulary.SEP, Vocabulary.MASK]
    tokens.extend(sorted(chars))
    tokens.extend("##" + c for c in sorted(chars))
    seen = set(tokens)
    for word, n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(tokens) >= max_size:
            break
        if n >= min_count and word not in seen and len(word) > 1:
            tokens.append(word)
            seen.add(word)
    return Vocabulary(tokens[:max_size])
