"""Hierarchization kernels (CUDA sources in ``csrc``) and their oracles."""
