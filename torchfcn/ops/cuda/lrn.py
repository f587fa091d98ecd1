"""Caffe across-channel LRN: wrapper of ``csrc/lrn.cu`` (``torchfcn_lrn``).

Counterpart of ``tpufcn/ops/pallas/lrn.py::lrn_pallas``.  The plain version
is ``torchfcn.ops.caffe_layers.lrn_across_channels``.
"""

from __future__ import annotations

import torch

from torchfcn.ops.caffe_layers import lrn_across_channels
from torchfcn.ops.cuda import build


def check_lrn_input(x: torch.Tensor, size: int, what: str) -> None:
    """Raise on what the LRN kernels do not take."""
    build.require_cuda(x, what)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: takes float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0 or not x.is_contiguous():
        raise ValueError(f"{what}: input must be a contiguous channels-last "
                         f"tensor, got shape {tuple(x.shape)}")
    if size < 1 or size % 2 == 0:
        raise ValueError(f"{what}: size must be odd and positive, got {size}")


def lrn_cuda(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
             k: float = 1.0) -> torch.Tensor:
    """LRN (beta 0.75) over the last (channel) axis of a channels-last
    tensor."""
    if x.device.type == "cpu":
        return lrn_across_channels(x, size, alpha, k)
    check_lrn_input(x, size, "lrn_cuda")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    c = x.shape[-1]
    build.launch("torchfcn_lrn", x.device, x.data_ptr(), y.data_ptr(),
                 x.numel() // c, c, size, alpha / size, k,
                 build.DTYPE_CODES[x.dtype])
    lrn_cuda.launches += 1
    return y


lrn_cuda.launches = 0
