"""Kernels of the port: hand-written CUDA for Hopper, with plain versions."""
