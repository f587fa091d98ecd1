"""Wrappers of the port's hand-written CUDA kernels (``torchfcn/csrc``).

Each wrapper takes its kernel's plain PyTorch version for CPU tensors,
launches the kernel for CUDA tensors, and raises for anything else.  Each
keeps a count of its kernel launches in its ``launches`` attribute.
"""
