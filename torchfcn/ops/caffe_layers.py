"""Caffe-semantics primitives of the GoogLeNet stem, plain PyTorch, NHWC.

These are the plain versions of the port's LRN kernels
(``torchfcn/ops/cuda/lrn.py``, ``lrn_pool.py``) and the counterparts of
``tpufcn/ops/caffe_layers.py``: same layout (channels last), same rounding.
"""

from __future__ import annotations

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
                   pad: int = 0) -> torch.Tensor:
    """Ceil-mode max pooling over NHWC: the last window may hang past the
    edge and maxes against -inf (Caffe's geometry is torch's ceil_mode).
    float8 input (which ``max_pool2d`` does not take) is pooled in bf16 and
    returned in float8: the max of float8 values is exact."""
    if x.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
        return max_pool_caffe(x.to(torch.bfloat16), kernel, stride,
                              pad).to(x.dtype)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, pad,
                     ceil_mode=True)
    return y.permute(0, 2, 3, 1)
