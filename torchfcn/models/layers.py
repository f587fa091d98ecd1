"""Building blocks of the port's models (``tpufcn/models/layers.py``).

Modules take and return NCHW tensors kept ``channels_last`` (NHWC in
memory), so the LRN kernels read contiguous channel rows; ``nhwc`` and
``nchw`` switch the view without copying such a tensor.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from torchfcn.ops.caffe_layers import max_pool_caffe
from torchfcn.ops.cuda.lrn import lrn_cuda
from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def max_pool(x: torch.Tensor, kernel: int, stride: int,
             pad: int = 0) -> torch.Tensor:
    """Caffe ceil-mode max pool on NCHW."""
    return nchw(max_pool_caffe(nhwc(x), kernel, stride, pad))


class CaffeConv(nn.Conv2d):
    """Conv2d with Caffe geometry (explicit symmetric padding).

    Parameters start at zero; ``init_xavier_`` draws the Caffe "xavier"
    filler from an explicit generator, or a converter loads them.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, pad: int = 0):
        super().__init__(in_channels, out_channels, kernel, stride, pad)

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)

    @torch.no_grad()
    def init_xavier_(self, generator: torch.Generator) -> None:
        """Caffe "xavier": uniform(-a, a), a = sqrt(3 / fan_in); bias 0."""
        a = math.sqrt(3.0 / self.weight[0].numel())
        self.weight.uniform_(-a, a, generator=generator)
        self.bias.zero_()


class LRN(nn.Module):
    """Caffe across-channel LRN (beta 0.75) through the ``lrn`` kernel."""

    def __init__(self, size: int = 5, alpha: float = 1e-4):
        super().__init__()
        self.size, self.alpha = size, alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(lrn_cuda(nhwc(x).contiguous(), self.size, self.alpha))


class LRNMaxPool(LRN):
    """LRN then the Caffe ceil-mode 3x3/2 max pool, through the fused
    ``lrn_maxpool`` kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(lrn_maxpool_cuda(nhwc(x).contiguous(), self.size,
                                     self.alpha))
