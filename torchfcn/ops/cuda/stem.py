"""The GoogLeNet stem tail fused into one kernel: wrapper of ``csrc/stem.cu``
(``torchfcn_stem_tail``).

Counterpart of ``tpufcn/ops/pallas/stem.py::stem_tail_pallas``.  The plain
version is ``torchfcn.ops.stem.stem_tail``.  The kernel's geometry is
computed here and checked again by the kernel: ``shared_bytes`` (one
block's shared memory) and ``geometry.stripe_plan`` (which pool rows each
block walks).

The wrapper calls the custom op ``torchfcn::stem_tail`` (kernel on a CUDA
tensor, plain version on a CPU one, a fake implementation for tracing).
``halo_top`` / ``halo_bottom`` run it on a row shard whose input carries its
neighbours' rows (``torchfcn.ops.stem.stem_tail``).
It has no backward: the stem tail serves the e5m2 preset, which the JAX
package refuses to train, so the wrapper raises when an input needs a
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchfcn.ops.caffe_layers import pooled_size
from torchfcn.ops.cuda import build
from torchfcn.ops.cuda.geometry import sm_count, stripe_plan
from torchfcn.ops.stem import stem_tail

CIN, CMID, COUT = 64, 64, 192
MTILE = 16                     # pixels of an mma m-tile
MAX_WIDTH = 128                # 4 warps along M x 2 m-tiles x 16 pixels
STAGE_STRIDE = 200             # staging row stride of a conv2 row (bf16)


def shared_bytes(w: int) -> int:
    """Dynamic shared memory of one block for input width ``w``, in bf16
    elements times 2 plus the two float32 biases.  Must match
    ``csrc/stem.cu::shared_bytes_for``: a ring of 3 reduce-conv rows (the
    m-tiles' pixels and a zero column each side), three conv2 weight taps,
    the reduce weights, the staging area (a conv2 row, or LRN1's output
    over the m-tiles and its input row) and one pooled row."""
    mtiles = -(-w // MTILE)
    ring = 3 * (MTILE * mtiles + 2) * CMID
    taps = 3 * COUT * CMID
    stage = max(w * STAGE_STRIDE, (MTILE * mtiles + w) * CIN)
    pooled = pooled_size(w, 3, 2) * COUT
    return (ring + taps + CMID * CIN + stage + pooled) * 2 + (CMID + COUT) * 4


def _out_rows(h: int, halo_top: int, halo_bottom: int) -> int:
    return (h - halo_top - halo_bottom) // 2


@torch.library.custom_op("torchfcn::stem_tail", mutates_args=(),
                         device_types="cpu")
def stem_tail_op(x: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor,
                 store_dtype: Optional[torch.dtype], halo_top: int = 0,
                 halo_bottom: int = 0) -> torch.Tensor:
    """The plain version on a CPU tensor."""
    return stem_tail(x, wr, br, w2, b2, store_dtype, halo_top, halo_bottom)


@stem_tail_op.register_kernel("cuda")
def _stem_tail_kernel(x: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor,
                      store_dtype: Optional[torch.dtype], halo_top: int = 0,
                      halo_bottom: int = 0) -> torch.Tensor:
    storage = check_inputs(x, wr, br, w2, b2, store_dtype, halo_top,
                           halo_bottom)
    b, h, w, _ = x.shape
    smem = shared_bytes(w)
    ho, wo = _out_rows(h, halo_top, halo_bottom), pooled_size(w, 3, 2)
    y = torch.empty((b, ho, wo, COUT), dtype=storage, device=x.device)
    if y.numel() == 0:
        return y
    rows, stripes = stripe_plan(b, ho, sm_count(x.device))
    # the kernel's layouts, K contiguous: wr as [co][ci], w2 as
    # [dy][dx][co][ci], bf16
    wr_t = wr.reshape(CMID, CIN).to(torch.bfloat16).contiguous()
    w2_t = w2.permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()
    br_f = br.to(torch.float32).contiguous()
    b2_f = b2.to(torch.float32).contiguous()
    build.launch("torchfcn_stem_tail", x.device, x.data_ptr(),
                 wr_t.data_ptr(), br_f.data_ptr(), w2_t.data_ptr(),
                 b2_f.data_ptr(), y.data_ptr(), b, h, w, ho, wo, rows,
                 stripes, smem, build.DTYPE_CODES[storage], halo_top,
                 halo_bottom)
    stem_tail_cuda.launches += 1
    return y


@stem_tail_op.register_fake
def _stem_tail_fake(x, wr, br, w2, b2, store_dtype, halo_top=0,
                    halo_bottom=0):
    b, h, w, _ = x.shape
    return x.new_empty((b, _out_rows(h, halo_top, halo_bottom),
                        pooled_size(w, 3, 2), COUT),
                       dtype=store_dtype or torch.bfloat16)


def stem_tail_cuda(x: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   store_dtype: Optional[torch.dtype] = None,
                   halo_top: int = 0, halo_bottom: int = 0) -> torch.Tensor:
    """LRN1 -> conv2_reduce 1x1 + ReLU -> conv2 3x3 + ReLU -> LRN2 -> 3x3/2
    ceil pool on (B, H, W, 64) NHWC; returns (B, Ho, Wo, 192) in
    ``store_dtype`` (bf16 when None).  Weights in OIHW: ``wr`` (64, 64, 1,
    1), ``w2`` (192, 64, 3, 3).  On the card ``x`` must already be in the
    storage type: bf16, or e5m2 for ``store_dtype=torch.float8_e5m2``, with
    3 <= W <= 128.  On a row shard the first ``halo_top`` and last
    ``halo_bottom`` rows of ``x`` are the neighbours' data and Ho is half
    the shard's (even) rows.  Raises if an input needs a gradient: the stem
    tail is serving-only."""
    build.check_device(x, "stem_tail_cuda")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wr, br, w2, b2)):
        raise RuntimeError(
            "stem_tail_cuda has no backward: the fused stem tail serves the "
            "e5m2 preset only; train the exact model (e.g. "
            "googlenet_detectnet), whose snapshots load into the preset")
    return stem_tail_op(x, wr, br, w2, b2, store_dtype, halo_top, halo_bottom)


stem_tail_cuda.launches = 0


def check_inputs(x: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor,
                 store_dtype: Optional[torch.dtype], halo_top: int = 0,
                 halo_bottom: int = 0) -> torch.dtype:
    """Raise on what the kernel does not take; returns the storage type."""
    storage = store_dtype or torch.bfloat16
    if storage not in (torch.bfloat16, torch.float8_e5m2):
        raise TypeError(f"stem_tail_cuda: stores bfloat16 or float8_e5m2, "
                        f"got {storage}")
    if x.dtype != storage:
        raise TypeError(f"stem_tail_cuda: input must be {storage}, got "
                        f"{x.dtype}")
    if x.dim() != 4 or x.shape[-1] != CIN or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"stem_tail_cuda: need contiguous, 16-byte aligned "
                         f"(B, H, W, {CIN}) NHWC, got {tuple(x.shape)}")
    if tuple(wr.shape) != (CMID, CIN, 1, 1) or tuple(br.shape) != (CMID,) \
            or tuple(w2.shape) != (COUT, CMID, 3, 3) \
            or tuple(b2.shape) != (COUT,):
        raise ValueError("stem_tail_cuda: weights must be (64, 64, 1, 1), "
                         "(64,), (192, 64, 3, 3), (192,)")
    if any(t.device != x.device for t in (wr, br, w2, b2)):
        raise ValueError("stem_tail_cuda: weights and input on one device")
    h, w = x.shape[1:3]
    if h < 3 or w < 3:
        raise ValueError(f"stem_tail_cuda: the 3x3 pool needs H, W >= 3, "
                         f"got {h}x{w}")
    if w > MAX_WIDTH:
        raise ValueError(f"stem_tail_cuda: the kernel takes widths up to "
                         f"{MAX_WIDTH}, got {w}")
    rows = h - halo_top - halo_bottom
    if halo_top < 0 or halo_bottom < 0 or rows < 2 or (
            (halo_top or halo_bottom) and rows % 2):
        raise ValueError(f"stem_tail_cuda: a row shard needs an even count "
                         f"of its own rows besides the halo, got {h} rows "
                         f"with halos {halo_top} and {halo_bottom}")
    return storage
