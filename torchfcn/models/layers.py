"""Building blocks of the port's models (``tpufcn/models/layers.py``).

Modules take and return NCHW tensors kept ``channels_last`` (NHWC in
memory), so the LRN kernels read contiguous channel rows; ``nhwc`` and
``nchw`` switch the view without copying such a tensor.

``ZooModel`` is the base of every model of the zoo: the seeded Caffe
"xavier" init and the map from the port's parameter names to the leaves
of the JAX package's Flax tree, which ``torchfcn.convert.from_jax`` loads.

A conv computes in its parameters' dtype unless a ``DTypePolicy`` gave it
a compute dtype (``torchfcn.core.dtypes``); the models read each conv's
``dtype`` to cast activations.  ``dropout`` is the models' train-mode
dropout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torchfcn.ops.caffe_layers import (
    avg_pool_caffe, max_pool_caffe, upsample_bilinear_separable)
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


def check_store_dtype(store_dtype) -> None:
    """Activation storage is e5m2 or none: e4m3 saturates at 448, below
    the activations of trained nets (the JAX package's presets use e5m2)."""
    if store_dtype not in (None, torch.float8_e5m2):
        raise ValueError(f"store_dtype must be None or float8_e5m2, got "
                         f"{store_dtype}")


def avg_pool(x: torch.Tensor, kernel: int, stride: int,
             pad: int = 0) -> torch.Tensor:
    """Caffe ceil-mode average pool on NCHW (float32 sums, Caffe's
    divisor, the input dtype out)."""
    return nchw(avg_pool_caffe(nhwc(x), kernel, stride, pad))


def upsample_factor(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Caffe FCN upsampling by ``factor`` on NCHW: the fixed bilinear
    deconvolution with k = 2f - f%2, s = f, p = ceil((f - 1) / 2), in its
    separable form; the input dtype out."""
    kernel = 2 * factor - factor % 2
    pad = math.ceil((factor - 1) / 2.0)
    return nchw(upsample_bilinear_separable(nhwc(x), kernel, factor, pad))


class CaffeConv(nn.Conv2d):
    """Conv2d with Caffe geometry (explicit symmetric padding), the JAX
    package's ``CaffeConv``, whose Flax ``nn.Conv`` is its child "conv".

    Parameters start at zero; ``ZooModel.init_weights`` draws them from an
    explicit generator, or a converter loads them.  With a
    ``compute_dtype`` (set by ``DTypePolicy.apply``) the weights and the
    input are cast to it for the convolution.
    """

    flax_child = "conv"
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, pad: int = 0, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride, pad,
                         bias=bias)

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the convolution computes in."""
        return self.compute_dtype or self.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype       # no copy where a tensor already has it
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class Conv(CaffeConv):
    """A bias-free Flax ``nn.Conv`` used directly (the ResNet's), whose
    kernel is a leaf of the module itself."""

    flax_child = None

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, pad: int = 0):
        super().__init__(in_channels, out_channels, kernel, stride, pad,
                         bias=False)


class GroupNorm(nn.GroupNorm):
    """Flax ``nn.GroupNorm(num_groups=32, dtype=float32)``: normalises in
    float32 with Flax's epsilon 1e-6 and returns float32.  Its scale and
    bias stay float32 when the model is cast to another dtype, as Flax
    keeps them (``param_dtype`` float32)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def _apply(self, fn, recurse=True):
        # a cast of the model moves these parameters but keeps them float32
        device = fn(torch.empty(0)).device
        return super()._apply(lambda t: t.to(device), recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.to(torch.float32), self.num_groups,
                            self.weight, self.bias, self.eps)


class ZooModel(nn.Module):
    """Base of the zoo's models.

    ``FLAX_NAMES`` renames the port's module names to the JAX package's
    (Caffe layer names, some with a slash); ``flax_paths`` derives from it
    the path of every parameter's leaf in the Flax tree.
    """

    FLAX_NAMES: Dict[str, str] = {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded Caffe "xavier" init of every conv, in registration order:
        uniform(-a, a), a = sqrt(3 / fan_in), bias 0.  GroupNorms keep
        scale 1 and bias 0.  Draws from ``generator`` only."""
        for module in self.modules():
            if isinstance(module, CaffeConv):
                a = math.sqrt(3.0 / module.weight[0].numel())
                module.weight.uniform_(-a, a, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()

    def flax_paths(self) -> Dict[str, Tuple[str, ...]]:
        """Port parameter name -> path of its Flax leaf, e.g.
        ``backbone.conv4_3.weight`` -> (backbone, conv4_3, conv, kernel).
        A conv's weight is the leaf ``kernel``, a GroupNorm's ``scale``."""
        paths = {}
        for name, module in self.named_modules():
            path = tuple(self.FLAX_NAMES.get(part, part)
                         for part in name.split("."))
            if getattr(module, "flax_child", None):
                path += (module.flax_child,)
            weight = "scale" if isinstance(module, nn.GroupNorm) else "kernel"
            for leaf, _ in module.named_parameters(recurse=False):
                paths[f"{name}.{leaf}"] = path + (
                    weight if leaf == "weight" else leaf,)
        return paths


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (Flax ``nn.Dropout``): in training, each value is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``,
    else zeroed, from uniform draws of ``generator`` (on ``x``'s device)
    in NHWC order; the identity in eval mode or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit "
                         "torch.Generator: pass generator=")
    draws = torch.rand(nhwc(x).shape, generator=generator, device=x.device)
    keep = nchw(draws) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


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
