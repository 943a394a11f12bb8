"""Word-complexity scorer and `[MASK]` marking (counterpart of
`dclip_tpu/data/text_complexity.py`), host code only.

- The token factor counts a word's subwords with the given tokenizer (the
  port's `data.tokenizer.CLIPTokenizer.tokenize`): 1 -> 0.0, 2 -> 0.3,
  3 -> 0.6, 4 or more -> 0.8.
- The semantic factor is 1 - the mean cosine of the word's 5 nearest
  neighbours in a GloVe-format text file (`word v1 v2 ...` a line; the
  word itself excluded), 0.9 for a word the table lacks, and only for
  words longer than 2 characters.
- With vectors the score is 0.6 * token + 0.4 * semantic, else the token
  factor; `mark_complex_words` replaces each word scoring above the
  threshold (0.35) with `[MASK]`.

The vectors load from a local file only; numpy computes the neighbours.
"""
from __future__ import annotations

import string
from typing import Dict, Optional

import numpy as np


class WordVectors:
    """Minimal GloVe-text-format word-vector table with top-k neighbors."""

    def __init__(self, vocab: Dict[str, int], matrix: np.ndarray):
        self.vocab = vocab
        norms = np.linalg.norm(matrix, axis=1, keepdims=True)
        self.matrix = matrix / np.maximum(norms, 1e-12)

    @classmethod
    def load_glove_txt(cls, path: str, max_words: Optional[int] = None) -> "WordVectors":
        vocab: Dict[str, int] = {}
        rows = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                if len(parts) < 3:
                    continue
                vocab[parts[0]] = len(rows)
                rows.append(np.asarray(parts[1:], np.float32))
                if max_words and len(rows) >= max_words:
                    break
        return cls(vocab, np.stack(rows))

    def __contains__(self, word: str) -> bool:
        return word in self.vocab

    def mean_top_similarity(self, word: str, topn: int = 5) -> float:
        """Mean cosine similarity of the top-n nearest neighbors
        (gensim `most_similar` semantics: the word itself excluded)."""
        idx = self.vocab[word]
        sims = self.matrix @ self.matrix[idx]
        sims[idx] = -np.inf
        k = min(topn, len(sims) - 1)
        top = np.partition(sims, -k)[-k:]
        return float(np.mean(top))


class ComplexityScorer:
    def __init__(
        self,
        tokenizer,
        word_vectors: Optional[WordVectors] = None,
        complexity_threshold: float = 0.35,
    ):
        self.tokenizer = tokenizer
        self.word_vectors = word_vectors
        self.complexity_threshold = complexity_threshold
        self._cache: Dict[str, float] = {}

    def compute_word_complexity(self, word: str) -> float:
        clean = word.strip(string.punctuation).lower()
        if clean in self._cache:
            return self._cache[clean]
        n_tokens = len(self.tokenizer.tokenize(clean)) if clean else 0
        if n_tokens <= 1:
            token_score = 0.0
        elif n_tokens == 2:
            token_score = 0.3
        elif n_tokens == 3:
            token_score = 0.6
        else:
            token_score = 0.8
        if self.word_vectors is not None:
            embedding_score = 0.0
            if len(clean) > 2:
                if clean in self.word_vectors:
                    embedding_score = 1.0 - self.word_vectors.mean_top_similarity(clean)
                else:
                    embedding_score = 0.9
            score = 0.6 * token_score + 0.4 * embedding_score
        else:
            score = token_score
        self._cache[clean] = score
        return score

    def mark_complex_words(self, text: str) -> str:
        return " ".join(
            "[MASK]"
            if self.compute_word_complexity(w) > self.complexity_threshold
            else w
            for w in text.split()
        )
