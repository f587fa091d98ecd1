"""The GoogLeNet stem tail, plain PyTorch, NHWC: the plain version of the
``stem_tail`` CUDA kernel (``torchfcn/ops/cuda/stem.py``) and the
counterpart of ``tpufcn/ops/pallas/stem.py``.

    pool1 output -> LRN1 -> conv2/3x3_reduce 1x1 + ReLU -> conv2/3x3 + ReLU
                 -> LRN2 -> pool2 3x3/2 (ceil mode)

Rounding follows the TPU kernel ``stem_tail_pallas``, not the XLA model:
each conv multiplies bf16 operands, accumulates, adds the float32 bias,
applies ReLU and rounds once to bf16; the LRNs are the bf16
``lrn_across_channels``.  With ``store_dtype=torch.float8_e5m2`` the LRN1,
conv2_reduce, conv2 and LRN2 outputs are further rounded to e5m2, as the
serving model stores them (``tpufcn/models/googlenet.py:186-200``).

Weights are in the port's (PyTorch) layout: ``wr`` (64, 64, 1, 1) and ``w2``
(192, 64, 3, 3) OIHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from torchfcn.ops.caffe_layers import lrn_across_channels, max_pool_caffe


def _store(x: torch.Tensor, store_dtype: Optional[torch.dtype]):
    """bf16 ``x`` rounded to the storage type and widened back to bf16."""
    if store_dtype is None:
        return x
    return x.to(store_dtype).to(torch.bfloat16)


def conv_relu_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int = 1, pad: int = 0) -> torch.Tensor:
    """NHWC conv of bf16 operands and a float32 bias, ReLU, one rounding to
    bf16.  The sums run in float64, where products of bf16 values and their
    sums over a 3x3x64 window are exact, so the result is the exactly
    rounded one, whatever order a device sums in.  A float32 sum's order
    can flip a rounding by one bf16 ulp; with e5m2 storage such a flip in
    one layer grows to two e5m2 steps two layers on, where the kernels
    (float32 sums) agree with the exact sums."""
    y = F.conv2d(x.permute(0, 3, 1, 2).double(),
                 w.to(torch.bfloat16).double(), b.float().double(), stride,
                 pad)
    return torch.relu(y).to(torch.bfloat16).permute(0, 2, 3, 1)


def stem_tail(pool1_out: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              store_dtype: Optional[torch.dtype] = None,
              halo_top: int = 0, halo_bottom: int = 0) -> torch.Tensor:
    """LRN1 -> conv2_reduce -> conv2 -> LRN2 -> pool2 on (B, H, W, 64) NHWC;
    returns (B, Ho, Wo, 192) contiguous, Ho and Wo Caffe's ceil-mode pooled
    sizes, in ``store_dtype`` (bf16 when None).  conv2's zero padding pads
    the reduce conv's output, and pool2's window edges past the image max
    against -inf.

    A row shard: the first ``halo_top`` and last ``halo_bottom`` input rows
    belong to the shards above and below.  They are data (only rows outside
    the input are conv2's zero padding); the pool's windows start at the
    shard's own rows 0, 2, ... and Ho is half the shard's rows (an even
    count)."""
    rows = pool1_out.shape[1] - halo_top - halo_bottom
    x = pool1_out.to(torch.bfloat16)
    x = _store(lrn_across_channels(x), store_dtype)
    x = _store(conv_relu_bf16(x, wr, br), store_dtype)
    x = _store(conv_relu_bf16(x, w2, b2, pad=1), store_dtype)
    x = _store(lrn_across_channels(x), store_dtype)
    y = max_pool_caffe(x[:, halo_top:], 3, 2)[:, :rows // 2]
    return y.to(store_dtype or torch.bfloat16).contiguous()


def googlenet_stem(x_u8: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   wr: torch.Tensor, br: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor) -> torch.Tensor:
    """The whole stem (``googlenet_stem_pallas``): raw (B, H, W, 3) BGR
    frames -> Power(-127) shift -> conv1 7x7/2 + ReLU -> pool1 -> stem
    tail; (B, H/8, W/8, 192) bf16 for H, W divisible by 8."""
    x = (x_u8.to(torch.float32) - 127.0).to(torch.bfloat16)
    x = max_pool_caffe(conv_relu_bf16(x, w1, b1, stride=2, pad=3), 3, 2)
    return stem_tail(x, wr, br, w2, b2)
