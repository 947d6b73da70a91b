"""Kernels of the port: each module pairs a hand-written CUDA kernel
(``csrc/``) with its plain PyTorch version and a launch counter
(``_kernels.py``)."""
