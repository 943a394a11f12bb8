"""Pure-Python BERT WordPiece tokenizer (counterpart of
`dclip_tpu/data/bert_tokenizer.py`), ids equal to
`transformers.BertTokenizer`'s on the same `vocab.txt`.

BasicTokenizer (clean, lowercase, strip accents, split punctuation, space
CJK characters) then greedy longest-match-first WordPiece. `encode` returns
(ids [T], attention_mask [T]) int32 numpy, `[CLS] pieces [SEP]` truncated
and `[PAD]`-padded to a fixed length, which `models.bert.BertEncoder`
takes as it is: string -> ids -> BERT -> `TextProjectionModule` -> the
CLIP space. Host code only; the port keeps its own copy of the rules.
"""
from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

_SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


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
    # ASCII blocks HF treats as punctuation even where unicode doesn't
    # (e.g. ^ $ `).
    if (
        33 <= cp <= 47
        or 58 <= cp <= 64
        or 91 <= cp <= 96
        or 123 <= cp <= 126
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BertWordPieceTokenizer:
    """bert-base-uncased-compatible tokenizer over a local vocab.txt."""

    def __init__(
        self,
        vocab: Dict[str, int],
        max_length: int = 128,
        do_lower_case: bool = True,
    ):
        self.vocab = dict(vocab)
        self.max_length = max_length
        self.do_lower_case = do_lower_case
        for tok in _SPECIAL:
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing special token {tok}")
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_vocab_file(
        cls, path: str, max_length: int = 128, do_lower_case: bool = True
    ) -> "BertWordPieceTokenizer":
        """Load a standard one-token-per-line vocab.txt (HF layout). `path`
        may also be a snapshot directory containing vocab.txt."""
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, max_length, do_lower_case)

    # -- basic tokenization --------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _space_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(token: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", token)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punc(token: str) -> List[str]:
        if token in _SPECIAL:
            return [token]
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._space_cjk(self._clean(text))
        out: List[str] = []
        for token in text.split():
            if token not in _SPECIAL:
                if self.do_lower_case:
                    token = self._strip_accents(token.lower())
                out.extend(self._split_punc(token))
                continue
            out.append(token)
        return [t for t in out if t]

    # -- WordPiece -----------------------------------------------------------

    def _wordpiece(self, token: str) -> List[str]:
        """Greedy longest-match-first (HF WordpieceTokenizer semantics)."""
        if len(token) > 100:
            return ["[UNK]"]
        pieces: List[str] = []
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
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in self._basic_tokenize(text):
            if token in _SPECIAL:
                out.append(token)
            else:
                out.extend(self._wordpiece(token))
        return out

    # -- encoding -------------------------------------------------------------

    def encode(
        self, text: str, max_length: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """[CLS] pieces [SEP], truncated to max_length, [PAD]-padded.
        Returns (ids [T], attention_mask [T]) int32."""
        T = max_length or self.max_length
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = [self.cls_id] + ids[: T - 2] + [self.sep_id]
        mask = [1] * len(ids)
        pad = T - len(ids)
        ids += [self.pad_id] * pad
        mask += [0] * pad
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def encode_batch(
        self, texts: Sequence[str], max_length: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(t, max_length) for t in texts]
        return (
            np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]),
        )

    def decode(self, ids: Iterable[int]) -> str:
        toks = [
            self.ids_to_tokens.get(int(i), "[UNK]")
            for i in ids
            if int(i) not in (self.pad_id, self.cls_id, self.sep_id)
        ]
        text = " ".join(toks).replace(" ##", "")
        return text
