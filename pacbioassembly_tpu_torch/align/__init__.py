"""Banded alignment on PyTorch: the plain row DP and the CUDA kernels."""
