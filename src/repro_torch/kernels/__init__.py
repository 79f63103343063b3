"""Hand-written Hopper kernels (CUDA C++) with their plain
PyTorch versions; ``ops`` dispatches between them by device."""
