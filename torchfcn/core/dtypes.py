"""Dtype policy of the port (``tpufcn/core/dtypes.py``): float32
parameters, convolutions in a compute dtype, float32 accumulation.

Parameters and optimizer state stay float32; each convolution casts its
weights (and its input) to ``compute_dtype``, as the JAX package's Flax
modules do with ``dtype=bfloat16, param_dtype=float32``.  cuDNN accumulates
bf16 convolutions in float32.  ``parity()`` computes in float32 and turns
TF32 off, for cuDNN convolutions and for matmuls, while its
``precision()`` scope is open: a float32 model on the card runs in TF32 by
PyTorch's default for cuDNN, which keeps about three decimal digits.

``apply`` puts a policy on a model of the zoo; the serving default of the
port casts the whole model to one dtype instead (``Detector(dtype=...)``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Tuple

import torch
import torch.nn as nn


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        # kept for the JAX package's API: cuDNN and the kernels accumulate
        # bf16 and float32 convolutions in float32, and nothing else is
        # offered
        if self.accum_dtype != torch.float32:
            raise ValueError(f"accum_dtype must be torch.float32, got "
                             f"{self.accum_dtype}")

    @classmethod
    def parity(cls) -> "DTypePolicy":
        """Full float32, TF32 off: numerical parity with the reference."""
        return cls(compute_dtype=torch.float32)

    @classmethod
    def fast(cls) -> "DTypePolicy":
        return cls(compute_dtype=torch.bfloat16)

    @property
    def exact(self) -> bool:
        return self.compute_dtype == torch.float32

    def apply(self, model: nn.Module) -> nn.Module:
        """Parameters in ``param_dtype`` (GroupNorms stay float32 anyway)
        and every convolution computing in ``compute_dtype``; in place."""
        from torchfcn.models.layers import CaffeConv
        model.to(dtype=self.param_dtype)
        for module in model.modules():
            if isinstance(module, CaffeConv):
                module.compute_dtype = self.compute_dtype
        return model

    def precision(self):
        """The scope to run a model under this policy in: TF32 off for a
        float32 policy, nothing for another."""
        return float32_exact() if self.exact else contextlib.nullcontext()


def _tf32_flags() -> Tuple[Tuple[object, str, object], ...]:
    """(holder, attribute, value that turns TF32 off) for cuDNN
    convolutions and for matmuls.  PyTorch builds with the
    ``fp32_precision`` settings refuse to read the legacy ``allow_tf32``
    flags once the newer settings were used, but read the newer ones
    whatever set them, so those are saved and restored where they exist."""
    backends = torch.backends
    conv = getattr(backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        return ((conv, "fp32_precision", "ieee"),
                (backends.cuda.matmul, "fp32_precision", "ieee"))
    return ((backends.cudnn, "allow_tf32", False),
            (backends.cuda.matmul, "allow_tf32", False))


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and matmuls inside the scope; the
    caller's settings come back when it closes."""
    flags = _tf32_flags()
    saved = [getattr(holder, name) for holder, name, _ in flags]
    try:
        for holder, name, off in flags:
            setattr(holder, name, off)
        yield
    finally:
        for (holder, name, _), value in zip(flags, saved):
            setattr(holder, name, value)
