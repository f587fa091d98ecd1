"""Caffe-semantics primitives, plain PyTorch, NHWC: the counterparts of
``tpufcn/ops/caffe_layers.py``, with the same layout (channels last) and
rounding.

The LRN functions are the plain versions of the port's LRN kernels
(``torchfcn/ops/cuda/lrn.py``, ``lrn_pool.py``).  Pooling follows Caffe's
ceil-mode geometry.  Every Deconvolution of the reference nets is a fixed
bilinear depthwise one: ``upsample_bilinear_separable`` computes it as two
dense products, as the JAX models do, and ``upsample_bilinear_caffe`` as
the transposed conv itself, which the tests hold it against.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def lrn_across_channels(x: torch.Tensor,
                        size: int = 5,
                        alpha: float = 1e-4,
                        k: float = 1.0) -> torch.Tensor:
    """Caffe LRN across channels: x / (k + alpha/size * sum_win x^2)^0.75.

    ``x`` is channels-last (NHWC or any pixel-major shape).  The window slides
    over the last axis with zero padding.  Rounding follows the reference: in
    bf16 the squares are rounded to bf16 and the window sum is float32; in
    float32 everything is float32.  beta is 0.75, as in every LRN of the
    reference nets, computed as ``rsqrt(s) * rsqrt(sqrt(s))``.
    """
    if x.dtype == torch.bfloat16:
        sq = (x * x).float()
    else:
        xf = x.float()
        sq = xf * xf
    c, half = x.shape[-1], size // 2
    padded = F.pad(sq, (half, half))
    win = padded[..., 0:c]
    for i in range(1, size):
        win = win + padded[..., i:i + c]
    s = k + (alpha / size) * win
    inv = torch.rsqrt(s) * torch.rsqrt(torch.sqrt(s))
    return (x.float() * inv).to(x.dtype)


def pooled_size(n: int, kernel: int, stride: int, pad: int = 0) -> int:
    """Caffe's ceil-mode pooled size, with its rule that the last window
    starts inside the padded input."""
    out = -(-(n + 2 * pad - kernel) // stride) + 1
    if pad > 0 and (out - 1) * stride >= n + pad:
        out -= 1
    return out


def max_pool_caffe(x: torch.Tensor, kernel: int, stride: int,
                   pad=0) -> torch.Tensor:
    """Ceil-mode max pooling over NHWC: the last window may hang past the
    edge and maxes against -inf (Caffe's geometry is torch's ceil_mode).
    ``pad`` is one padding or (rows, columns).  float8 input (which
    ``max_pool2d`` does not take) is pooled in bf16 and returned in float8:
    the max of float8 values is exact."""
    if x.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
        return max_pool_caffe(x.to(torch.bfloat16), kernel, stride,
                              pad).to(x.dtype)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, pad,
                     ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def _bilinear_taps(kernel: int) -> np.ndarray:
    """The 1-D Caffe bilinear filler in float64: f = ceil(k/2),
    c = (2f - 1 - f%2) / (2f), v[x] = 1 - |x/f - c|."""
    f = math.ceil(kernel / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    return 1.0 - np.abs(np.arange(kernel, dtype=np.float64) / f - c)


def bilinear_kernel(kernel: int) -> torch.Tensor:
    """Caffe "bilinear" filler, the 2-D (kernel, kernel) float32 outer
    product of the 1-D filler."""
    v = _bilinear_taps(kernel)
    return torch.from_numpy(np.outer(v, v).astype(np.float32))


def bilinear_upsample_matrix(in_size: int, kernel: int, stride: int,
                             pad: int) -> np.ndarray:
    """Dense (out, in) float32 matrix of the 1-D bilinear transposed conv:
    ``U[o, i] = v[o + pad - i * stride]`` where that index lies in
    ``[0, kernel)``; out = (in - 1) * stride + kernel - 2 * pad."""
    v = _bilinear_taps(kernel)
    out = (in_size - 1) * stride + kernel - 2 * pad
    kidx = (np.arange(out)[:, None] + pad
            - np.arange(in_size)[None, :] * stride)
    inside = (kidx >= 0) & (kidx < kernel)
    return np.where(inside, v[np.clip(kidx, 0, kernel - 1)],
                    0.0).astype(np.float32)


def upsample_bilinear_separable(x: torch.Tensor, kernel: int, stride: int,
                                pad: int, uy: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The fixed bilinear depthwise deconvolution of
    :func:`upsample_bilinear_caffe` over NHWC as two dense products, H then
    W, with the float32 interpolation matrices.  The products run in
    float64, which TF32 never touches, so they are at least as exact as
    IEEE float32 whatever ``torch.backends`` allows; the result is rounded
    once to the input dtype.  ``uy`` replaces the row matrix (a band of a
    larger frame's, for a row shard)."""
    if uy is None:
        uy = torch.from_numpy(bilinear_upsample_matrix(x.shape[-3], kernel,
                                                       stride, pad))
    ux = torch.from_numpy(bilinear_upsample_matrix(x.shape[-2], kernel,
                                                   stride, pad))
    wide = dict(dtype=torch.float64, device=x.device)
    y = torch.einsum("yh,bhwc->bywc", uy.to(**wide), x.to(**wide))
    y = torch.einsum("xw,bywc->byxc", ux.to(**wide), y)
    return y.to(x.dtype, memory_format=torch.contiguous_format)


def conv_transpose_caffe(x: torch.Tensor, w: torch.Tensor, stride: int,
                         pad: int, groups: int = 1) -> torch.Tensor:
    """Transposed conv over NHWC with Caffe's geometry,
    out = (in - 1) * stride + kernel - 2 * pad, as the input-dilated
    forward conv with ``w`` (HWIO, the equivalent forward conv's kernel,
    as in the JAX package).  Computes in float32 (on a card through cuDNN,
    under its TF32 setting) and returns the input dtype."""
    k = w.shape[0]
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    b, c, h, wd = xf.shape
    dilated = xf.new_zeros(b, c, (h - 1) * stride + 1, (wd - 1) * stride + 1)
    dilated[..., ::stride, ::stride] = xf
    y = F.conv2d(dilated, w.to(xf).permute(3, 2, 0, 1), padding=k - 1 - pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample_bilinear_caffe(x: torch.Tensor, kernel: int, stride: int,
                            pad: int) -> torch.Tensor:
    """Caffe ``Deconvolution(group=C, weight_filler=bilinear,
    bias_term=false)`` over NHWC: the depthwise transposed conv with the
    bilinear filler, in float32, returned in the input dtype."""
    c = x.shape[-1]
    w = bilinear_kernel(kernel)[:, :, None, None].expand(kernel, kernel, 1, c)
    return conv_transpose_caffe(x, w, stride, pad, groups=c)
