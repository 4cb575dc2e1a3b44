"""Correlation building blocks and the hand-written CUDA kernels with their plain twins."""
