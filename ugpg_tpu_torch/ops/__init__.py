"""Tensor ops of the port: plain PyTorch resizes and the CUDA kernels."""
