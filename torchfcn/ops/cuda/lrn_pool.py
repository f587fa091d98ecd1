"""LRN fused with the Caffe ceil-mode 3x3/2 max pool: wrapper of
``csrc/lrn.cu`` (``torchfcn_lrn_maxpool``).

Counterpart of ``tpufcn/ops/pallas/lrn_pool.py::lrn_maxpool_pallas``.  The
plain version is ``max_pool_caffe(lrn_across_channels(x), 3, 2)``.
"""

from __future__ import annotations

import torch

from torchfcn.ops.caffe_layers import (
    lrn_across_channels, max_pool_caffe, pooled_size)
from torchfcn.ops.cuda import build
from torchfcn.ops.cuda.lrn import check_lrn_input


def lrn_maxpool_cuda(x: torch.Tensor, size: int = 5,
                     alpha: float = 1e-4) -> torch.Tensor:
    """LRN (beta 0.75, k 1) then the 3x3/2 ceil-mode max pool:
    (B, H, W, C) NHWC -> (B, ceil((H-3)/2)+1, ceil((W-3)/2)+1, C)."""
    if x.device.type == "cpu":
        return max_pool_caffe(lrn_across_channels(x, size, alpha), 3, 2)
    check_lrn_input(x, size, "lrn_maxpool_cuda")
    if x.dim() != 4:
        raise ValueError(f"lrn_maxpool_cuda: need NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if h < 3 or w < 3:
        raise ValueError(f"lrn_maxpool_cuda: the 3x3 pool needs H, W >= 3, "
                         f"got {h}x{w}")
    ho, wo = pooled_size(h, 3, 2), pooled_size(w, 3, 2)
    y = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    build.launch("torchfcn_lrn_maxpool", x.device, x.data_ptr(), y.data_ptr(),
                 b, h, w, c, ho, wo, size, alpha / size, 1.0,
                 build.DTYPE_CODES[x.dtype])
    lrn_maxpool_cuda.launches += 1
    return y


lrn_maxpool_cuda.launches = 0
