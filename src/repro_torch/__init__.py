"""PyTorch/CUDA port of the budgeted SGD SVM with precomputed golden section search.

The JAX package ``repro`` is the reference; this package computes the same
training and serving paths in PyTorch, with its hand-written CUDA kernels
(``kernels``) for the NVIDIA H100, and reads and writes the same checkpoints
(``checkpoint``).  It imports nothing from ``repro`` or JAX.
"""
