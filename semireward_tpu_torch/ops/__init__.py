"""Kernels of the port (CUDA sources in ``csrc/``) with their plain versions."""
