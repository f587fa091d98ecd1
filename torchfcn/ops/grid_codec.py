"""DetectNet grid -> candidate box decoder (``tpufcn/ops/grid_codec.py``
``decode_gridboxes``), batched over images."""

from __future__ import annotations

import torch

from torchfcn.core.config import GridConfig


def decode_gridboxes(coverage: torch.Tensor,
                     bbox: torch.Tensor,
                     grid: GridConfig,
                     prob_thresh: float = 0.5):
    """Decode coverage + bbox grids to candidate corner boxes, all classes.

    Every grid cell yields ``(x1, y1, x2, y2) = bbox_offsets + cell_origin``
    (reference ``gridbox_to_boxes``, scripts/fcn_object_detector.py:357-394);
    cells with ``coverage < prob_thresh`` are masked invalid, not dropped.

    Args:
      coverage: (B, gh, gw, C) per-class coverage probability.
      bbox: (B, gh, gw, 4C) per-class corner offsets (Caffe channel order).
      grid: decode geometry (cell size = image size / grid size).
      prob_thresh: coverage mask threshold.

    Returns:
      boxes: (B, C, G, 4) float corner boxes, G = gh * gw.
      cvg:   (B, C, G) coverage values.
      valid: (B, C, G) bool mask of above-threshold cells.
    """
    b = coverage.shape[0]
    gh, gw, c = grid.grid_h, grid.grid_w, grid.num_classes
    dev = coverage.device
    mx = torch.arange(gw, dtype=torch.float32, device=dev) * float(grid.cell_w)
    my = torch.arange(gh, dtype=torch.float32, device=dev) * float(grid.cell_h)
    mx, my = mx[None, :].expand(gh, gw), my[:, None].expand(gh, gw)
    origin = torch.stack([mx, my, mx, my], dim=-1)          # (gh, gw, 4)

    offsets = bbox.reshape(b, gh, gw, c, 4)
    boxes = offsets + origin[:, :, None, :]                 # (B, gh, gw, C, 4)
    boxes = boxes.permute(0, 3, 1, 2, 4).reshape(b, c, gh * gw, 4)

    cvg = coverage.permute(0, 3, 1, 2).reshape(b, c, gh * gw)
    return boxes, cvg, cvg >= prob_thresh
