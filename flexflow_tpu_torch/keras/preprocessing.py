"""Keras-style preprocessing utilities: the JAX package's
keras/preprocessing.py (after FlexFlow's
python/flexflow/keras/preprocessing/{sequence,text}.py, which re-export
keras_preprocessing — implemented natively here)."""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np


def pad_sequences(sequences: Sequence[Sequence[int]], maxlen: Optional[int] = None,
                  dtype="int32", padding: str = "pre", truncating: str = "pre",
                  value: float = 0.0) -> np.ndarray:
    """Pad/truncate variable-length id sequences to a [N, maxlen] array."""
    if maxlen is None:
        maxlen = max((len(s) for s in sequences), default=0)
    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, seq in enumerate(sequences):
        seq = list(seq)
        if len(seq) > maxlen:
            seq = seq[-maxlen:] if truncating == "pre" else seq[:maxlen]
        if not seq:
            continue
        if padding == "pre":
            out[i, -len(seq):] = seq
        else:
            out[i, :len(seq)] = seq
    return out


def make_sampling_table(size: int, sampling_factor: float = 1e-5) -> np.ndarray:
    """Word-rank keep-probability table (Zipf assumption) for skipgram
    subsampling."""
    gamma = 0.577
    rank = np.arange(size)
    rank[0] = 1
    inv_fq = rank * (np.log(rank) + gamma) + 0.5 - 1.0 / (12.0 * rank)
    f = sampling_factor * inv_fq
    return np.minimum(1.0, f / np.sqrt(f))


def skipgrams(sequence: Sequence[int], vocabulary_size: int, window_size: int = 4,
              negative_samples: float = 1.0, shuffle: bool = True,
              sampling_table: Optional[np.ndarray] = None, seed: int = 0):
    """(couples, labels) skip-gram pairs with uniform negative sampling."""
    rng = np.random.default_rng(seed)
    couples: List[List[int]] = []
    labels: List[int] = []
    for i, wi in enumerate(sequence):
        if not wi:
            continue
        if sampling_table is not None and rng.random() > sampling_table[wi]:
            continue
        lo = max(0, i - window_size)
        hi = min(len(sequence), i + window_size + 1)
        for j in range(lo, hi):
            if j == i or not sequence[j]:
                continue
            couples.append([wi, int(sequence[j])])
            labels.append(1)
    n_neg = int(len(labels) * negative_samples)
    if n_neg:
        words = [c[0] for c in couples]
        rng.shuffle(words)
        for k in range(n_neg):
            couples.append(
                [words[k % len(words)], int(rng.integers(1, vocabulary_size))]
            )
            labels.append(0)
    if shuffle:
        order = rng.permutation(len(couples))
        couples = [couples[i] for i in order]
        labels = [labels[i] for i in order]
    return couples, labels


_SPLIT_RE = re.compile(r"[\s!\"#$%&()*+,\-./:;<=>?@\[\\\]^_`{|}~\t\n]+")


def text_to_word_sequence(text: str, lower: bool = True) -> List[str]:
    if lower:
        text = text.lower()
    return [w for w in _SPLIT_RE.split(text) if w]


def one_hot(text: str, n: int, lower: bool = True) -> List[int]:
    """Hashing-trick word ids in [1, n) (collisions possible, as in Keras)."""
    return [1 + (hash(w) % (n - 1)) for w in text_to_word_sequence(text, lower)]


class Tokenizer:
    """Word-index tokenizer (reference: keras preprocessing.text.Tokenizer)."""

    def __init__(self, num_words: Optional[int] = None, lower: bool = True,
                 oov_token: Optional[str] = None):
        self.num_words = num_words
        self.lower = lower
        self.oov_token = oov_token
        self.word_counts: Counter = Counter()
        self.word_index: Dict[str, int] = {}

    def fit_on_texts(self, texts: Sequence[str]) -> None:
        for text in texts:
            self.word_counts.update(text_to_word_sequence(text, self.lower))
        vocab = [w for w, _ in self.word_counts.most_common()]
        if self.oov_token is not None:
            vocab = [self.oov_token] + [w for w in vocab if w != self.oov_token]
        self.word_index = {w: i + 1 for i, w in enumerate(vocab)}

    def _id(self, word: str) -> Optional[int]:
        i = self.word_index.get(word)
        if i is not None and (self.num_words is None or i < self.num_words):
            return i
        if self.oov_token is not None:
            return self.word_index[self.oov_token]
        return None

    def texts_to_sequences(self, texts: Sequence[str]) -> List[List[int]]:
        out = []
        for text in texts:
            ids = [self._id(w) for w in text_to_word_sequence(text, self.lower)]
            out.append([i for i in ids if i is not None])
        return out

    def texts_to_matrix(self, texts: Sequence[str], mode: str = "binary") -> np.ndarray:
        n = self.num_words or (len(self.word_index) + 1)
        m = np.zeros((len(texts), n), np.float32)
        for row, seq in enumerate(self.texts_to_sequences(texts)):
            for i in seq:
                if mode == "count":
                    m[row, i] += 1.0
                else:
                    m[row, i] = 1.0
        return m
