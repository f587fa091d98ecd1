"""LRN fused with the Caffe ceil-mode 3x3/2 max pool: wrapper of
``csrc/lrn.cu`` (``torchfcn_lrn_maxpool``).

Counterpart of ``tpufcn/ops/pallas/lrn_pool.py::lrn_maxpool_pallas``.  The
plain version is ``lrn_maxpool`` below.  The kernel's geometry
(``lrn_maxpool_plan``) is computed here and checked again by the kernel.
The wrapper calls the custom op ``torchfcn::lrn_maxpool``, whose backward
is the vector-Jacobian product of the plain version, as ``lrn.py``'s.

On a row shard (the (data, space) mesh) the wrapper takes the shard with
its neighbours' rows, ``halo_top`` above and ``halo_bottom`` below, runs
the unchanged kernel on it and keeps the pool rows whose windows start at
the shard's own rows: an interior shard of even rows with one row below
pools to exactly its rows, and at the frame's bottom the ceil mode gives the
global edge.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchfcn.ops.caffe_layers import (
    lrn_across_channels, max_pool_caffe, pooled_size)
from torchfcn.ops.cuda import build
from torchfcn.ops.cuda.geometry import (
    SHARED_BYTES_MAX, blocks_fit, sm_count, stripe_plan)
from torchfcn.ops.cuda.lrn import (
    HEADER_BYTES, check_lrn_input, plain_vjp, save_input, vector_instance)

POOL_SLOTS = 2             # csrc/lrn.cu kPoolSlots
POOL_BLOCKS_PER_SM = 2     # blocks the plan fills on each SM


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def lrn_maxpool_shared_bytes(col_tile: int, channels: int, itemsize: int,
                             vector: bool) -> int:
    """Dynamic shared memory of one block; must match
    ``csrc/lrn.cu::lrn_maxpool_shared_bytes``: the barriers, two LRN rows
    and (vector instance) two staged input rows of ``2 col_tile + 1``
    columns, and one pooled row of ``col_tile`` columns."""
    row = _round16((2 * col_tile + 1) * channels * itemsize)
    rows = 2 + (POOL_SLOTS if vector else 0)
    return HEADER_BYTES + rows * row + _round16(col_tile * channels * itemsize)


def lrn_maxpool_plan(batch: int, h: int, w: int, channels: int,
                     itemsize: int, vector: bool,
                     sms: int) -> Tuple[int, int, int, int, int]:
    """(pool rows per stripe, stripes, pool columns per tile, tiles, shared
    bytes).  The grid is one block per (image, stripe, tile).  The kernel is
    bound by each SM's arithmetic, so the plan minimises the work of the
    busiest SM: its blocks, ceil(blocks / sms), times each block's input
    rows and columns (a stripe rereads its first row, a tile its first
    column).  Candidates: 1 to 4 times the fewest column tiles of which 2
    blocks fit an SM (1 where a channel row is too large for 2), each with
    ``geometry.stripe_plan`` filling that many block slots per SM; ties go
    to fewer tiles.  At B = 8, 112^2, 192 channels on 132 SMs, in bf16 and in
    float32: 4 tiles of 14 pool columns, 8 stripes of 7 pool rows, 256
    blocks."""
    ho, wo = pooled_size(h, 3, 2), pooled_size(w, 3, 2)

    def smem(tiles: int) -> int:
        return lrn_maxpool_shared_bytes(-(-wo // tiles), channels, itemsize,
                                        vector)

    fewest = next((t for t in range(1, wo + 1)
                   if blocks_fit(smem(t)) >= POOL_BLOCKS_PER_SM), None)
    if fewest is None:
        if smem(wo) > SHARED_BYTES_MAX:
            raise ValueError(f"lrn_maxpool_cuda: a row of {channels} channels "
                             f"does not fit the kernel's shared memory")
        fewest = next(t for t in range(1, wo + 1)
                      if smem(t) <= SHARED_BYTES_MAX)
    best = None
    for tiles in range(fewest, min(4 * fewest, wo) + 1):
        tile = -(-wo // tiles)
        if -(-wo // tile) != tiles:    # the same tiles as a smaller count
            continue
        per_sm = min(POOL_BLOCKS_PER_SM, blocks_fit(smem(tiles)))
        rows, stripes = stripe_plan(batch * tiles, ho, sms * per_sm)
        busiest = -(-batch * tiles * stripes // sms)
        cost = busiest * (2 * rows + 1) * min(2 * tile + 1, w)
        if best is None or cost < best[0]:
            best = (cost, (rows, stripes, tile, tiles, smem(tiles)))
    return best[1]


def _shard_rows(x: torch.Tensor, y: torch.Tensor, halo_top: int,
                halo_bottom: int) -> torch.Tensor:
    """The pool rows of ``y`` (pooled from ``x``) whose windows start at the
    shard's own rows."""
    if not (halo_top or halo_bottom):
        return y
    rows = x.shape[1] - halo_top - halo_bottom
    if halo_top < 0 or halo_bottom < 0 or halo_top % 2 or rows < 2 \
            or rows % 2:
        raise ValueError(f"lrn_maxpool on a row shard needs an even halo "
                         f"above and an even count of the shard's own rows, "
                         f"got {x.shape[1]} rows with halos {halo_top} and "
                         f"{halo_bottom}")
    return y[:, halo_top // 2:halo_top // 2 + rows // 2]


def lrn_maxpool(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                halo_top: int = 0, halo_bottom: int = 0) -> torch.Tensor:
    """The plain version: LRN (k 1) then the 3x3/2 ceil-mode max pool; on a
    row shard with halo rows, the shard's pool rows."""
    y = max_pool_caffe(lrn_across_channels(x, size, alpha), 3, 2)
    return _shard_rows(x, y, halo_top, halo_bottom)


@torch.library.custom_op("torchfcn::lrn_maxpool", mutates_args=(),
                         device_types="cpu")
def lrn_maxpool_op(x: torch.Tensor, size: int, alpha: float) -> torch.Tensor:
    """The plain version on a CPU tensor."""
    return lrn_maxpool(x, size, alpha).contiguous()


def _pooled_shape(x: torch.Tensor):
    b, h, w, c = x.shape
    return b, pooled_size(h, 3, 2), pooled_size(w, 3, 2), c


@lrn_maxpool_op.register_kernel("cuda")
def _lrn_maxpool_kernel(x: torch.Tensor, size: int,
                        alpha: float) -> torch.Tensor:
    check_lrn_input(x, size, "lrn_maxpool_cuda")
    if x.dim() != 4:
        raise ValueError(f"lrn_maxpool_cuda: need NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if h < 3 or w < 3:
        raise ValueError(f"lrn_maxpool_cuda: the 3x3 pool needs H, W >= 3, "
                         f"got {h}x{w}")
    _, ho, wo, _ = _pooled_shape(x)
    y = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    vector = vector_instance(x.dtype, c, x.data_ptr())
    rows, stripes, tile, tiles, smem = lrn_maxpool_plan(
        b, h, w, c, x.element_size(), vector, sm_count(x.device))
    build.launch("torchfcn_lrn_maxpool", x.device, x.data_ptr(), y.data_ptr(),
                 b, h, w, c, ho, wo, size, alpha / size, 1.0,
                 build.DTYPE_CODES[x.dtype], int(vector), rows, stripes, tile,
                 tiles, smem)
    lrn_maxpool_cuda.launches += 1
    return y


@lrn_maxpool_op.register_fake
def _lrn_maxpool_fake(x, size, alpha):
    return x.new_empty(_pooled_shape(x))


def _lrn_maxpool_backward(ctx, grad):
    return plain_vjp(lrn_maxpool, ctx, grad), None, None


lrn_maxpool_op.register_autograd(_lrn_maxpool_backward,
                                 setup_context=save_input)


def lrn_maxpool_cuda(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                     halo_top: int = 0, halo_bottom: int = 0) -> torch.Tensor:
    """LRN (beta 0.75, k 1) then the 3x3/2 ceil-mode max pool:
    (B, H, W, C) NHWC -> (B, ceil((H-3)/2)+1, ceil((W-3)/2)+1, C); the
    kernel on a CUDA tensor, the plain version on a CPU one; differentiable
    on both.  On a row shard whose first ``halo_top`` and last
    ``halo_bottom`` rows are its neighbours': the shard's pool rows."""
    build.check_device(x, "lrn_maxpool_cuda")
    return _shard_rows(x, lrn_maxpool_op(x, size, alpha), halo_top,
                       halo_bottom)


lrn_maxpool_cuda.launches = 0
