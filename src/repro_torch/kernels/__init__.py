"""Hand-written Hopper kernels (CUDA C++ and Triton) with their plain
PyTorch versions; ``ops`` dispatches between them by device."""
