"""Serving: dynamic request batching onto the bucket-padded ClipService."""
from dclip_tpu_torch.serve.batcher import DynamicBatcher
from dclip_tpu_torch.serve.service import ClipService, pad_to_bucket

__all__ = ["ClipService", "DynamicBatcher", "pad_to_bucket"]
