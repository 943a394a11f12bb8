"""Hand-written CUDA kernels for Hopper (`csrc/`), their Python wrappers
and plain PyTorch twins. Importing this package builds nothing: the
library is compiled with nvcc at the first CUDA launch (`_build.py`)."""
