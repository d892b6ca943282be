"""Compute plane of the port: serving-side scoring and the wrappers of
the hand-written CUDA kernels (``ops/cuda_kernels.py``)."""
