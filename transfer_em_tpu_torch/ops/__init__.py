"""Tensor ops of the port: convs, normalization and the CUDA kernels."""
