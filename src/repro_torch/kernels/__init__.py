"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions.  Sources live in ``csrc/``; ``_build`` compiles them at first
use.  Importing this package builds nothing."""
