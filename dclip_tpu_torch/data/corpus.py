"""Corpus / eval JSON loading (counterpart of `dclip_tpu/data/corpus.py:316-321`).

Only `load_corpus` is ported; the corpus builders wait (ROADMAP Queue 1).
"""
from __future__ import annotations

import json
from typing import List


def load_corpus(path: str) -> List[dict]:
    """Load a corpus / eval JSON, dropping items with no captions (the
    filter the retrieval eval applies, reference flickr30k_eval.py:97-100)."""
    with open(path) as f:
        data = json.load(f)
    return [d for d in data if d.get("captions")]
