"""Operators of the port. ``ops.kernels`` holds the hand-written CUDA kernels."""
