"""Host-side geometry shared by the kernels that walk stripes of pool rows
(``csrc/stem.cu``, ``csrc/lrn.cu``): the SM count, the H100's
shared-memory limits and the stripe plan.  Each kernel checks the plan it is given again."""

from __future__ import annotations

from typing import Tuple

import torch

# dynamic shared memory one block may use, and one SM holds (H100: 227 and
# 228 KB; the card keeps 1 KB of each SM's share for every resident block)
SHARED_BYTES_MAX = 232448
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def blocks_fit(shared_bytes: int) -> int:
    """How many blocks of ``shared_bytes`` dynamic shared memory one SM
    holds."""
    return SM_SHARED_BYTES // (shared_bytes + BLOCK_RESERVED_BYTES)


def stripe_plan(batch: int, ho: int, sms: int) -> Tuple[int, int]:
    """(pool rows per stripe, stripes per image): the grid is one block per
    (stripe, image), each walking its stripe's pool rows down.  A stripe's
    first pool row recomputes one input row, so stripes are as long as
    filling ``sms`` block slots allows: on the H100's 132 SMs at B = 8,
    Ho = 56, 14 stripes of 4 rows (112 blocks); at B = 1, one row each."""
    wanted = max(1, min(ho, sms // max(batch, 1)))
    rows = -(-ho // wanted)
    return rows, -(-ho // rows)
