"""CLIP BPE tokenizer, pure Python, HF-`CLIPTokenizer`-compatible.

A copy of `dclip_tpu/data/tokenizer.py` (host code only). It is copied,
not imported, because `dclip_tpu/data/__init__.py` imports the input
pipeline, which imports jax; tests/test_torch_serve.py checks that the
two produce the same ids.

The reference tokenizes through `CLIPProcessor`/`CLIPTokenizer`
(training/text_tokenizer.py:22-25, truncation to 77 tokens at :160). This
implementation produces identical ids from the same `vocab.json` +
`merges.txt` files (verified against `transformers.CLIPTokenizer` in
tests/test_tokenizer.py), but with a zero-egress loading story: vocab files
come from an explicit local path, never the network.

Also carries the 77-token greedy chunker (`split_into_chunks`,
text_tokenizer.py:121-143) used for long captions.

For unit tests without real vocab files, `HashTokenizer` maps words to
stable ids in a configurable vocab — same interface, no files.
"""
from __future__ import annotations

import gzip
import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # `regex` supports \p{L}/\p{N} like the original CLIP tokenizer.
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


try:  # pragma: no cover - environment-dependent, mirrors HF's dispatch
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

# transformers.BasicTokenizer's CJK ranges (tokenize_chinese_chars).
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _basic_clean_tokenize(text: str) -> str:
    """transformers.BasicTokenizer(strip_accents=False,
    do_split_on_punc=False) semantics, which HF's CLIPTokenizer applies
    when ftfy is NOT installed: drop NUL/replacement/control+format
    chars, normalize whitespace, space out CJK chars (each becomes its
    own regex word, so it gets its own </w>), NFC, lowercase."""
    import unicodedata

    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        if ch in ("\t", "\n", "\r"):
            out.append(" ")
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C"):
            continue  # control/format (incl. zero-width space)
        if cat == "Zs":
            out.append(" ")
            continue
        if _is_cjk(cp):
            out.extend((" ", ch, " "))
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(t.lower() for t in text.split())


def _clip_normalize(text: str) -> str:
    """The exact text cleanup HF's CLIPTokenizer applies before the BPE
    regex — which depends on whether ftfy is installed (same dispatch as
    transformers.CLIPTokenizer.__init__, for id parity either way)."""
    if _ftfy is not None:  # pragma: no cover - ftfy absent in CI image
        return _whitespace_clean(_ftfy.fix_text(text)).lower()
    return _basic_clean_tokenize(text)


class CLIPTokenizer:
    """Byte-level BPE with CLIP's end-of-word markers and special tokens."""

    PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        re.IGNORECASE,
    )

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        max_length: int = 77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.max_length = max_length
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_token_id = self.encoder[self.bos_token]
        self.eos_token_id = self.encoder[self.eos_token]
        # HF CLIPTokenizer uses eos as the pad token.
        self.pad_token_id = self.eos_token_id
        self._cache: Dict[str, str] = {
            self.bos_token: self.bos_token,
            self.eos_token: self.eos_token,
        }

    # -- construction ------------------------------------------------------

    @classmethod
    def from_files(
        cls, vocab_file: str, merges_file: str, max_length: int = 77
    ) -> "CLIPTokenizer":
        """Load HF-format vocab.json + merges.txt (or OpenAI's merged
        bpe_simple_vocab_16e6.txt.gz as the merges file)."""
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        opener = gzip.open if merges_file.endswith(".gz") else open
        with opener(merges_file, "rt", encoding="utf-8") as f:  # type: ignore[operator]
            lines = f.read().split("\n")
        lines = lines[1:]  # first line is the version header
        if merges_file.endswith(".gz"):
            # OpenAI's bpe_simple_vocab_16e6.txt.gz carries MORE merges
            # than the 49,408-entry vocab was built from; CLIP keeps
            # merges[1:49152-256-2+1] = 48,894 rules (openai/CLIP
            # simple_tokenizer — header removal and cap in ONE slice). The
            # header is already dropped above, so cap at 49152-256-2 here.
            # Without this, out-of-vocab merged tokens crash/skew ids.
            lines = lines[: 49152 - 256 - 2]
        merges = []
        for line in lines:
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges, max_length)

    @classmethod
    def from_pretrained_dir(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        return cls.from_files(
            os.path.join(path, "vocab.json"),
            os.path.join(path, "merges.txt"),
            max_length,
        )

    # -- BPE ---------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    # -- public API --------------------------------------------------------

    def tokenize(self, text: str) -> List[int]:
        """Text -> BPE ids (no special tokens, no truncation)."""
        text = _clip_normalize(text)
        ids: List[int] = []
        for token in re.findall(self.PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for bpe_token in self._bpe(token).split(" "):
                ids.append(self.encoder[bpe_token])
        return ids

    def encode(
        self, text: str, max_length: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Text -> (input_ids [L], attention_mask [L]) padded to max_length.

        HF semantics: BOS + tokens + EOS, truncate to max_length keeping EOS,
        pad with eos (pad) token id.
        """
        max_length = max_length or self.max_length
        ids = self.tokenize(text)[: max_length - 2]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids = ids + [self.pad_token_id] * pad
        mask = mask + [0] * pad
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def encode_batch(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        enc = [self.encode(t, max_length) for t in texts]
        return np.stack([e[0] for e in enc]), np.stack([e[1] for e in enc])

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(
            self.decoder[i]
            for i in ids
            if i in self.decoder
            and self.decoder[i] not in (self.bos_token, self.eos_token)
        )
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def split_into_chunks(self, text: str, chunk_tokens: Optional[int] = None) -> List[str]:
        """Greedy word-boundary chunking so each chunk fits the context
        (reference text_tokenizer.py:121-143: accumulate words while the
        tokenized chunk stays under the limit)."""
        limit = (chunk_tokens or self.max_length) - 2  # room for BOS/EOS
        words = _whitespace_clean(text).split(" ")
        chunks: List[str] = []
        current: List[str] = []
        for word in words:
            candidate = " ".join(current + [word])
            if current and len(self.tokenize(candidate)) > limit:
                chunks.append(" ".join(current))
                current = [word]
            else:
                current.append(word)
        if current:
            chunks.append(" ".join(current))
        return chunks

    def word_token_count(self, word: str) -> int:
        """Subword count for the complexity scorer (text_tokenizer.py:53-103)."""
        return len(self.tokenize(word))


class HashTokenizer:
    """Deterministic test-only tokenizer: word -> stable hash id.

    Same interface as CLIPTokenizer so pipelines/tests run without vocab
    files. NOT CLIP-compatible numerically.
    """

    def __init__(self, vocab_size: int = 1000, max_length: int = 16):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.pad_token_id = self.eos_token_id

    def tokenize(self, text: str) -> List[int]:
        import hashlib

        out = []
        for w in _whitespace_clean(text).lower().split(" "):
            if not w:
                continue
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            out.append(1 + h % (self.vocab_size - 3))
        return out

    def encode(self, text: str, max_length: Optional[int] = None):
        max_length = max_length or self.max_length
        ids = self.tokenize(text)[: max_length - 2]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        return (
            np.asarray(ids + [self.pad_token_id] * pad, np.int32),
            np.asarray(mask + [0] * pad, np.int32),
        )

    def encode_batch(self, texts: Sequence[str], max_length: Optional[int] = None):
        enc = [self.encode(t, max_length) for t in texts]
        return np.stack([e[0] for e in enc]), np.stack([e[1] for e in enc])
