"""Batched groupRectangles NMS: wrapper of ``csrc/group_rects.cu``.

Counterpart of ``tpufcn/ops/pallas/group_rects.py::group_rectangles_pallas``.
The plain version is ``torchfcn.ops.group_rects.group_rectangles``.  The
wrapper calls the custom op ``torchfcn::group_rects`` (kernel on a CUDA
tensor, plain version on a CPU one, a fake implementation for tracing);
its outputs are integer-valued means, counts and a mask, so it has no
backward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchfcn.ops import group_rects as plain
from torchfcn.ops.cuda import build

# one thread block per instance, 56 bytes of shared memory per candidate
MAX_CANDIDATES = 4096


Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op("torchfcn::group_rects", mutates_args=(),
                         device_types="cpu")
def group_rects_op(rects: torch.Tensor, valid: torch.Tensor,
                   group_threshold: int, eps: float) -> Outputs:
    """The plain version on CPU tensors."""
    return tuple(plain.group_rectangles(rects, valid, group_threshold, eps))


@group_rects_op.register_kernel("cuda")
def _group_rects_kernel(rects: torch.Tensor, valid: torch.Tensor,
                        group_threshold: int, eps: float) -> Outputs:
    if rects.dim() != 3 or rects.shape[-1] != 4:
        raise ValueError(f"rects must be (M, N, 4), got {tuple(rects.shape)}")
    m, n = rects.shape[:2]
    if valid.shape != (m, n):
        raise ValueError(f"valid must be {(m, n)}, got {tuple(valid.shape)}")
    if rects.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"need float32 rects and bool valid, got "
                        f"{rects.dtype} and {valid.dtype}")
    if valid.device != rects.device:
        raise ValueError("rects and valid must be on one device")
    if not (rects.is_contiguous() and valid.is_contiguous()) \
            or rects.data_ptr() % 16:
        raise ValueError("rects and valid must be contiguous, rects 16-byte "
                         "aligned")
    if not 0 < n <= MAX_CANDIDATES:
        raise ValueError(f"the kernel takes 1..{MAX_CANDIDATES} candidates "
                         f"per instance, got {n}")

    out = _group_rects_fake(rects, valid, group_threshold, eps)
    if m == 0:
        return out
    build.launch("torchfcn_group_rects", rects.device,
                 rects.data_ptr(), valid.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), out[2].data_ptr(), m, n,
                 int(group_threshold), float(eps))
    group_rectangles_cuda.launches += 1
    return out


@group_rects_op.register_fake
def _group_rects_fake(rects, valid, group_threshold, eps) -> Outputs:
    m, n = rects.shape[:2]
    return (torch.empty_like(rects),
            rects.new_empty((m, n), dtype=torch.int32),
            rects.new_empty((m, n), dtype=torch.bool))


def group_rectangles_cuda(rects: torch.Tensor,
                          valid: torch.Tensor,
                          group_threshold: int = 3,
                          eps: float = 0.2) -> plain.GroupedRects:
    """groupRectangles over M instances of N candidates.

    Args:
      rects: (M, N, 4) float32 contiguous, read as (x, y, w, h).
      valid: (M, N) bool contiguous.
    Returns GroupedRects(rects (M, N, 4) float32, weights (M, N) int32,
    valid (M, N) bool), results in root-index slots.
    """
    build.check_device(rects, "group_rectangles_cuda")
    return plain.GroupedRects(*group_rects_op(rects, valid,
                                              int(group_threshold),
                                              float(eps)))


group_rectangles_cuda.launches = 0
