"""The GoogLeNet stem tail fused into one kernel: wrapper of ``csrc/stem.cu``
(``torchfcn_stem_tail``).

Counterpart of ``tpufcn/ops/pallas/stem.py::stem_tail_pallas``.  The plain
version is ``torchfcn.ops.stem.stem_tail``.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchfcn.ops.caffe_layers import pooled_size
from torchfcn.ops.cuda import build
from torchfcn.ops.stem import stem_tail

CIN, CMID, COUT = 64, 64, 192
XTILE = 8                      # conv2 output columns per thread tile
SHARED_BYTES_MAX = 232448      # dynamic shared memory a block may use (H100)


def shared_bytes(w: int) -> int:
    """Dynamic shared memory of one block for input width ``w``: five
    reduce-conv rows (bf16, one zero column each side, padded to whole
    tiles), three conv2 rows (bf16) and the two biases (float32).  Must
    match ``csrc/stem.cu``."""
    tiles = -(-w // XTILE)
    return (5 * (tiles * XTILE + 2) * CMID + 3 * w * COUT) * 2 \
        + (CMID + COUT) * 4


def stem_tail_cuda(x: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   store_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LRN1 -> conv2_reduce 1x1 + ReLU -> conv2 3x3 + ReLU -> LRN2 -> 3x3/2
    ceil pool on (B, H, W, 64) NHWC; returns (B, Ho, Wo, 192) in
    ``store_dtype`` (bf16 when None).  Weights in OIHW: ``wr`` (64, 64, 1,
    1), ``w2`` (192, 64, 3, 3).  On the card ``x`` must already be in the
    storage type: bf16, or e5m2 for ``store_dtype=torch.float8_e5m2``."""
    if x.device.type == "cpu":
        return stem_tail(x, wr, br, w2, b2, store_dtype)
    build.require_cuda(x, "stem_tail_cuda")
    storage = store_dtype or torch.bfloat16
    if storage not in (torch.bfloat16, torch.float8_e5m2):
        raise TypeError(f"stem_tail_cuda: stores bfloat16 or float8_e5m2, "
                        f"got {storage}")
    if x.dtype != storage:
        raise TypeError(f"stem_tail_cuda: input must be {storage}, got "
                        f"{x.dtype}")
    if x.dim() != 4 or x.shape[-1] != CIN or not x.is_contiguous():
        raise ValueError(f"stem_tail_cuda: need contiguous (B, H, W, {CIN}) "
                         f"NHWC, got {tuple(x.shape)}")
    if tuple(wr.shape) != (CMID, CIN, 1, 1) or tuple(br.shape) != (CMID,) \
            or tuple(w2.shape) != (COUT, CMID, 3, 3) \
            or tuple(b2.shape) != (COUT,):
        raise ValueError("stem_tail_cuda: weights must be (64, 64, 1, 1), "
                         "(64,), (192, 64, 3, 3), (192,)")
    if any(t.device != x.device for t in (wr, br, w2, b2)):
        raise ValueError("stem_tail_cuda: weights and input on one device")
    b, h, w, _ = x.shape
    if h < 3 or w < 3:
        raise ValueError(f"stem_tail_cuda: the 3x3 pool needs H, W >= 3, "
                         f"got {h}x{w}")
    smem = shared_bytes(w)
    if smem > SHARED_BYTES_MAX:
        raise ValueError(f"stem_tail_cuda: width {w} needs {smem} bytes of "
                         f"shared memory, more than {SHARED_BYTES_MAX}")

    ho, wo = pooled_size(h, 3, 2), pooled_size(w, 3, 2)
    y = torch.empty((b, ho, wo, COUT), dtype=storage, device=x.device)
    if y.numel() == 0:
        return y
    # the kernel's layouts: wr as [ci][co], w2 as [dy][dx][ci][co], bf16
    wr_t = wr.reshape(CMID, CIN).t().to(torch.bfloat16).contiguous()
    w2_t = w2.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    br_f = br.to(torch.float32).contiguous()
    b2_f = b2.to(torch.float32).contiguous()
    build.launch("torchfcn_stem_tail", x.device, x.data_ptr(),
                 wr_t.data_ptr(), br_f.data_ptr(), w2_t.data_ptr(),
                 b2_f.data_ptr(), y.data_ptr(), b, h, w, ho, wo, smem,
                 build.DTYPE_CODES[storage])
    stem_tail_cuda.launches += 1
    return y


stem_tail_cuda.launches = 0
