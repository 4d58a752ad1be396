"""Kernels (K1 in CUDA) and their host-side operators."""
