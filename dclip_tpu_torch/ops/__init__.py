"""Plain tensor ops of the serving path: CLIP normalization, exact k-NN."""
