"""CUDA C++ kernels for Hopper with their plain PyTorch versions and launch counts."""
