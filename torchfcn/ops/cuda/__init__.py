"""Wrappers of the port's hand-written CUDA kernels (``torchfcn/csrc``).

Each wrapper calls a custom op (``torch.ops.torchfcn``) whose CPU
implementation is the kernel's plain PyTorch version and whose CUDA
implementation launches the kernel; a tensor on another device finds no
implementation and raises.  Each wrapper keeps a count of its kernel
launches in its ``launches`` attribute.
"""
