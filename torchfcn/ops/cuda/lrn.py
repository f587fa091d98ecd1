"""Caffe across-channel LRN: wrapper of ``csrc/lrn.cu`` (``torchfcn_lrn``).

Counterpart of ``tpufcn/ops/pallas/lrn.py::lrn_pallas``.  The plain version
is ``torchfcn.ops.caffe_layers.lrn_across_channels``.  The kernel's
instance (``vector_instance``, shared with ``lrn_pool.py``) and geometry
(``lrn_plan``) are chosen here and checked again by the kernel.

The wrapper calls the custom op ``torchfcn::lrn``: the kernel on a CUDA
tensor, the plain version on a CPU tensor, a fake implementation for
tracing, and a backward that is the vector-Jacobian product of the plain
version, recomputed from the saved input (no Pallas kernel had a backward;
the JAX package trains through XLA's LRN).
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchfcn.ops.caffe_layers import lrn_across_channels
from torchfcn.ops.cuda import build
from torchfcn.ops.cuda.geometry import sm_count

HEADER_BYTES = 64          # csrc/lrn.cu kHeaderBytes: the ring's mbarriers
LRN_SLOTS = 3              # csrc/lrn.cu kLrnSlots
LRN_BLOCKS_PER_SM = 4      # csrc/lrn.cu kLrnBlocksPerSm
LRN_TILE_BYTES = 8192      # a vector tile: about this many bytes of pixels
SCALAR_TILE_ITEMS = 2048   # a scalar tile: about this many channels
# the largest channel row (bytes of one pixel) of the vector instance: the
# one whose lrn_maxpool block at its narrowest column tile (two staged and
# two LRN rows of 3 pixels, one pooled pixel: 13 channel rows) fits 227 KB
MAX_VECTOR_ROW_BYTES = 17872


def vector_instance(dtype: torch.dtype, channels: int, data_ptr: int) -> bool:
    """Whether the LRN kernels take their vector instance for an input of
    ``dtype`` with ``channels`` channels at address ``data_ptr``: 16-byte
    accesses of 8 bf16 or 4 float32 channels, rows staged into shared
    memory by bulk copies, which need rows of whole 16-byte units at a
    16-byte aligned address.  Otherwise the scalar instance of the same
    kernels: one channel per thread, read from device memory."""
    row = channels * dtype.itemsize
    return row % 16 == 0 and data_ptr % 16 == 0 \
        and row <= MAX_VECTOR_ROW_BYTES


def lrn_shared_bytes(tile_pixels: int, channels: int, itemsize: int,
                     vector: bool) -> int:
    """Dynamic shared memory of one ``lrn`` block; must match
    ``csrc/lrn.cu::lrn_shared_bytes``: the barriers and a ring of 3 tiles
    (vector instance), none in the scalar instance."""
    if not vector:
        return 0
    return HEADER_BYTES + LRN_SLOTS * tile_pixels * channels * itemsize


def lrn_plan(pixels: int, channels: int, itemsize: int, vector: bool,
             sms: int) -> Tuple[int, int, int]:
    """(pixels per tile, blocks, shared bytes): persistent blocks, 4 per SM
    at most, each walking every ``blocks``-th tile of consecutive pixels."""
    if vector:
        tile = max(1, LRN_TILE_BYTES // (channels * itemsize))
    else:
        tile = max(1, SCALAR_TILE_ITEMS // channels)
    tiles = -(-pixels // tile)
    blocks = min(tiles, sms * LRN_BLOCKS_PER_SM)
    return tile, blocks, lrn_shared_bytes(tile, channels, itemsize, vector)


def check_lrn_input(x: torch.Tensor, size: int, what: str) -> None:
    """Raise on what the LRN kernels do not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: takes float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0 or not x.is_contiguous():
        raise ValueError(f"{what}: input must be a contiguous channels-last "
                         f"tensor, got shape {tuple(x.shape)}")
    if size < 1 or size % 2 == 0:
        raise ValueError(f"{what}: size must be odd and positive, got {size}")


@torch.library.custom_op("torchfcn::lrn", mutates_args=(),
                         device_types="cpu")
def lrn_op(x: torch.Tensor, size: int, alpha: float,
           k: float) -> torch.Tensor:
    """The plain version on a CPU tensor."""
    return lrn_across_channels(x, size, alpha, k)


@lrn_op.register_kernel("cuda")
def _lrn_kernel(x: torch.Tensor, size: int, alpha: float,
                k: float) -> torch.Tensor:
    check_lrn_input(x, size, "lrn_cuda")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    c = x.shape[-1]
    vector = vector_instance(x.dtype, c, x.data_ptr())
    tile, blocks, smem = lrn_plan(x.numel() // c, c, x.element_size(),
                                  vector, sm_count(x.device))
    build.launch("torchfcn_lrn", x.device, x.data_ptr(), y.data_ptr(),
                 x.numel() // c, c, size, alpha / size, k,
                 build.DTYPE_CODES[x.dtype], int(vector), tile, blocks, smem)
    lrn_cuda.launches += 1
    return y


@lrn_op.register_fake
def _lrn_fake(x, size, alpha, k):
    return torch.empty_like(x)


def plain_vjp(plain, ctx, grad: torch.Tensor):
    """The input's gradient: the vector-Jacobian product of ``plain``
    (taking the input and ``ctx.args``) at the saved input, inside a
    profiler range ``torchfcn::<plain>_vjp`` that reads its device time
    (``torchfcn.serve.profile.range_device_us``)."""
    x, = ctx.saved_tensors
    with torch.profiler.record_function(f"torchfcn::{plain.__name__}_vjp"):
        _, vjp = torch.func.vjp(lambda t: plain(t, *ctx.args), x)
        return vjp(grad)[0]


def save_input(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[0])
    ctx.args = inputs[1:]


def _lrn_backward(ctx, grad):
    return (plain_vjp(lrn_across_channels, ctx, grad),) + (None,) * 3


lrn_op.register_autograd(_lrn_backward, setup_context=save_input)


def lrn_cuda(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
             k: float = 1.0) -> torch.Tensor:
    """LRN (beta 0.75) over the last (channel) axis of a channels-last
    tensor: the kernel on a CUDA tensor, the plain version on a CPU one;
    differentiable on both."""
    build.check_device(x, "lrn_cuda")
    return lrn_op(x, size, alpha, k)


lrn_cuda.launches = 0
