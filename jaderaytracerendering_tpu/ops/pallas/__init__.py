"""Pallas kernels (Triton route, compiled for the GPU)."""
