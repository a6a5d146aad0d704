"""Numerics: linear algebra, derivatives, and the CUDA kernels."""
