"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their wrappers and
their plain PyTorch versions (``ref``)."""
