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

Row sharding (``mesh`` with ``space > 1``, ``torchfcn.core.mesh``): each
rank holds a band of every frame's rows (``core.mesh.row_bands``: each
band but the last a multiple of 32 rows, which every net's deepest stride
divides, the last the remainder).  A conv or pool of kernel k, stride s
and padding p reads p halo rows from the rank above and k - s - p from
the rank below (``torchfcn.parallel.halo``), filled as the layer pads at
the frame's
edges (p rows of fill above and below), and runs with no row padding of
its own: each rank then computes exactly its own output rows, the last
band's too, where s need not divide its rows.  A ceil-mode pool without
padding takes no fill at the bottom edge, where its ceil mode reproduces
the global edge.  The across-channel LRN needs no halo.  What reads a
whole frame's rows (the pyramid's pools, GroupNorm's statistics) sums each
band's share over the space group (``parallel.all_reduce_sum``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torchfcn.core.mesh import Mesh, space_sharded
from torchfcn.ops.caffe_layers import (
    bilinear_upsample_matrix, max_pool_caffe, upsample_bilinear_separable)
from torchfcn.ops.cuda.lrn import lrn_cuda
from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda
from torchfcn.parallel.distributed import all_reduce_sum, band_sizes
from torchfcn.parallel.halo import attached, halo_rows


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def max_pool(x: torch.Tensor, kernel: int, stride: int, pad: int = 0,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Caffe ceil-mode max pool on NCHW; on a row shard, with its halo
    (-inf past the frame where the pool pads, none where it does not)."""
    if not space_sharded(mesh):
        return nchw(max_pool_caffe(nhwc(x), kernel, stride, pad))
    x = halo_rows(x, pad, max(kernel - stride - pad, 0), mesh,
                  fill=float("-inf") if pad else None, bottom_edge=pad)
    return nchw(max_pool_caffe(nhwc(x), kernel, stride, (0, pad)))


def max_pool_floor(x: torch.Tensor, kernel: int, stride: int, pad: int,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Floor-mode max pool with -inf padding on NCHW (Flax
    ``nn.max_pool``, the ResNet stem's); float8 through bf16, which keeps
    the max exact; on a row shard, with its halo (-inf past the frame)."""
    if x.dtype == torch.float8_e5m2:
        return max_pool_floor(x.to(torch.bfloat16), kernel, stride, pad,
                              mesh).to(x.dtype)
    if not space_sharded(mesh):
        return F.max_pool2d(x, kernel, stride, pad)
    x = halo_rows(x, pad, max(kernel - stride - pad, 0), mesh,
                  fill=float("-inf"), bottom_edge=pad)
    return F.max_pool2d(x, kernel, stride, (0, pad))


def check_store_dtype(store_dtype) -> None:
    """Activation storage is e5m2 or none: e4m3 saturates at 448, below
    the activations of trained nets (the JAX package's presets use e5m2)."""
    if store_dtype not in (None, torch.float8_e5m2):
        raise ValueError(f"store_dtype must be None or float8_e5m2, got "
                         f"{store_dtype}")


def upsample_factor(x: torch.Tensor, factor: int,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Caffe FCN upsampling by ``factor`` on NCHW: the fixed bilinear
    deconvolution with k = 2f - f%2, s = f, p = ceil((f - 1) / 2), in its
    separable form; the input dtype out.  On a row shard: the input rows
    with their halo (zeros past the frame) through this rank's band of the
    global row matrix, whose f x rows output rows read its input rows
    through the same taps wherever the band starts."""
    kernel = 2 * factor - factor % 2
    pad = math.ceil((factor - 1) / 2.0)
    if not space_sharded(mesh):
        return nchw(upsample_bilinear_separable(nhwc(x), kernel, factor, pad))
    rows = x.shape[-2]
    # output row o reads input rows i with 0 <= o + pad - i f < kernel
    top, bottom = (kernel - 1 - pad) // factor, (factor - 1 + pad) // factor
    # U[o, i] = v[o + pad - i f] depends on o - i f alone, so the band of
    # the global matrix (rows f first.., columns first - top..) is the same
    # for every first: the matrix of the halo'd band, from its row f top
    band = bilinear_upsample_matrix(top + rows + bottom, kernel, factor,
                                    pad)[factor * top:factor * (top + rows)]
    x = halo_rows(x, top, bottom, mesh, fill=0.0)
    return nchw(upsample_bilinear_separable(nhwc(x), kernel, factor, pad,
                                            uy=torch.from_numpy(band)))


def upsample_rows(x: torch.Tensor, factor: int, rows: slice) -> torch.Tensor:
    """``upsample_factor`` of a whole (replicated) small map, ``rows`` of
    its output alone: the full input through those rows of the global row
    matrix (a row-sharded rank's band of the upsampled map)."""
    kernel = 2 * factor - factor % 2
    pad = math.ceil((factor - 1) / 2.0)
    uy = bilinear_upsample_matrix(x.shape[-2], kernel, factor, pad)[rows]
    return nchw(upsample_bilinear_separable(nhwc(x), kernel, factor, pad,
                                            uy=torch.from_numpy(uy)))


def row_band(rows: int, mesh: Mesh) -> Tuple[int, int]:
    """(offset, global rows) of this rank's ``rows`` rows of an activation
    at one level of a row-sharded net (one all_gather of the bands'
    lengths over the space group)."""
    sizes = band_sizes(rows, mesh.space_group, mesh.device)
    return sum(sizes[:mesh.space_index]), sum(sizes)


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

    def forward(self, x: torch.Tensor,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        dtype = self.dtype       # no copy where a tensor already has it
        bias = None if self.bias is None else self.bias.to(dtype)
        if not space_sharded(mesh) or self.kernel_size[0] == 1:
            return self._conv_forward(x.to(dtype), self.weight.to(dtype),
                                      bias)
        (k, _), (s, _), (p, pw) = (self.kernel_size, self.stride,
                                   self.padding)
        x = halo_rows(x.to(dtype), p, max(k - s - p, 0), mesh, fill=0.0,
                      bottom_edge=p)
        return F.conv2d(x, self.weight.to(dtype), bias, self.stride, (0, pw),
                        self.dilation, self.groups)


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
    float32 with Flax's epsilon 1e-6 and returns float32 (a float64 input,
    under a float64 test policy, in float64).  Its scale and bias stay
    float32 when the model is cast to another dtype, as Flax keeps them
    (``param_dtype`` float32).

    Each sample's and group's mean and variance are computed in float64.
    On a row shard each band's sum and sum of squares (and count) are
    summed over the space group and the variance is Flax's
    ``use_fast_variance`` form, max(E[x^2] - E[x]^2, 0): so the statistics
    of a band's rows and of the whole frame's agree to float64 rounding,
    and a row-sharded net's bf16 layers downstream read what the unsharded
    net's read (float32 statistics summed in two orders move some of their
    roundings)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def _apply(self, fn, recurse=True):
        # a cast of the model moves these parameters but keeps them float32
        device = fn(torch.empty(0)).device
        return super()._apply(lambda t: t.to(device), recurse)

    def forward(self, x: torch.Tensor,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, torch.float32)
        b, c, h, w = x.shape
        g = self.num_groups
        wide = x.view(b, g, c // g, h, w).to(torch.float64)
        var, mean = torch.var_mean(wide, (2, 3, 4), correction=0)
        if space_sharded(mesh):
            n = torch.full_like(mean, wide[0, 0].numel())
            stats = all_reduce_sum(torch.stack(
                [mean * n, (var + mean * mean) * n, n]), mesh.space_group)
            mean = stats[0] / stats[2]
            var = torch.clamp(stats[1] / stats[2] - mean * mean, min=0.0)
        # per channel, (B, C, 1, 1): the output keeps x's memory format
        mul = (torch.rsqrt(var + self.eps)[..., None]
               * self.weight.view(g, -1)).view(b, c, 1, 1)
        mean = mean[..., None].expand(b, g, c // g).reshape(b, c, 1, 1)
        # a bf16 x widens in the subtraction, with no float32 copy of it
        return torch.addcmul(self.bias.to(dtype)[:, None, None],
                             x - mean.to(dtype), mul.to(dtype))


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
            generator: Optional[torch.Generator],
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Inverted dropout (Flax ``nn.Dropout``): in training, each value is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``,
    else zeroed, from uniform draws of ``generator`` (on ``x``'s device)
    in NHWC order; the identity in eval mode or at rate 0.  On a mesh every
    rank draws the global batch's values (its generator in step with the
    others') and keeps its batch shard and rows, so that N ranks drop what
    one device would."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit "
                         "torch.Generator: pass generator=")
    b, c, h, w = x.shape
    if mesh is None:
        draws = torch.rand((b, h, w, c), generator=generator,
                           device=x.device)
    else:
        first, rows = row_band(h, mesh) if space_sharded(mesh) else (0, h)
        draws = torch.rand((b * mesh.data, rows, w, c),
                           generator=generator, device=x.device)
        draws = draws[mesh.data_index * b:(mesh.data_index + 1) * b,
                      first:first + h]
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
    ``lrn_maxpool`` kernel; on a row shard, on the shard and the rank
    below's first row (none at the frame's bottom)."""

    def forward(self, x: torch.Tensor,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        if not space_sharded(mesh):
            return nchw(lrn_maxpool_cuda(nhwc(x).contiguous(), self.size,
                                         self.alpha))
        top, bottom = attached(0, 1, mesh, None)
        x = halo_rows(x, 0, 1, mesh, fill=None)
        return nchw(lrn_maxpool_cuda(nhwc(x).contiguous(), self.size,
                                     self.alpha, halo_top=top,
                                     halo_bottom=bottom))
