"""Host-side data code: tokenizers, embedding store, detection cache, the
corpus input pipeline, image resize/crop."""
