"""Host-side data code: tokenizers, embedding store, image resize/crop."""
