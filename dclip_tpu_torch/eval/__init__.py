"""Evaluation: Karpathy-split retrieval and zero-shot classification."""
