"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions (``ref``) and the wrappers that pick between them by the
tensors' device (``ops``). Importing this package builds nothing."""
