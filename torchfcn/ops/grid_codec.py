"""DetectNet grid codec (``tpufcn/ops/grid_codec.py``): the training label
encoder and the grid -> candidate box decoder, batched over images, on
the device of their inputs.

Encoder semantics of the reference (argumentation_engine.py:81-109):

* a grid cell is covered by a GT rect when the scaled Jaccard score
  (``torchfcn.ops.boxes.scaled_iou_xywh``) exceeds ``iou_thresh`` (0.1);
* per covered cell, class ``k`` writes channels ``[4k, 4k + 4)`` of the
  bbox block (GT corners relative to the cell origin), the size block
  ``(1/w, 1/h, 1/w, 1/h)``, the obj block ``cell_area / rect_area`` and the
  coverage block 1.0, and coverage channel ``k`` gets 1.0;
* GT rects are applied in order, the last writer winning per cell (the
  JAX package's ``lax.scan``, a loop over the M rects here).

Grids are channels-last: ``(B, gh, gw, C)`` and ``(B, gh, gw, 4C)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from torchfcn.core.config import GridConfig
from torchfcn.ops.boxes import scaled_iou_xywh


class GridLabels(NamedTuple):
    """The training tops of the reference data layer, minus the image."""

    coverage: torch.Tensor        # (..., gh, gw, C) foreground target
    bbox: torch.Tensor            # (..., gh, gw, 4C) corners rel. cell origin
    size: torch.Tensor            # (..., gh, gw, 4C) (1/w, 1/h, 1/w, 1/h)
    obj: torch.Tensor             # (..., gh, gw, 4C) cell_area / rect_area
    coverage_block: torch.Tensor  # (..., gh, gw, 4C) binary coverage mask


def grid_cells(grid: GridConfig, device=None) -> torch.Tensor:
    """(gh, gw, 4) float32 cell rects ``(x, y, stride, stride)``
    (reference ``grid_region``)."""
    gh, gw, s = grid.grid_h, grid.grid_w, grid.stride
    f32 = dict(dtype=torch.float32, device=device)
    xs = (torch.arange(gw, **f32) * s)[None, :].expand(gh, gw)
    ys = (torch.arange(gh, **f32) * s)[:, None].expand(gh, gw)
    wh = torch.full((gh, gw), float(s), **f32)
    return torch.stack([xs, ys, wh, wh], dim=-1)


def encode_grid_labels_batch(rects: torch.Tensor, labels: torch.Tensor,
                             valid: torch.Tensor, grid: GridConfig,
                             iou_thresh: float = 0.1) -> GridLabels:
    """Encode GT boxes into DetectNet label grids for a batch.

    Args:
      rects: (B, M, 4) (x, y, w, h) GT boxes, padded to capacity M.
      labels: (B, M) integer class ids; an id outside [0, C) writes
        nothing (as ``jax.nn.one_hot`` gives it no class).
      valid: (B, M) bool mask of the real boxes.
    Returns GridLabels of (B, gh, gw, C) / (B, gh, gw, 4C) float32 grids.
    """
    rects = rects.to(torch.float32)
    b, m = rects.shape[:2]
    gh, gw, c = grid.grid_h, grid.grid_w, grid.num_classes
    dev = rects.device
    cells = grid_cells(grid, dev)                          # (gh, gw, 4)
    cell_area = float(grid.stride * grid.stride)
    classes = torch.arange(c, device=dev)
    zeros = dict(dtype=torch.float32, device=dev)
    coverage = torch.zeros((b, gh, gw, c), **zeros)
    bbox, size, obj, cov_block = (torch.zeros((b, gh, gw, c, 4), **zeros)
                                  for _ in range(4))
    for i in range(m):
        rect = rects[:, i]                                 # (B, 4)
        x, y, w, h = (t[:, None, None] for t in rect.unbind(-1))
        score = scaled_iou_xywh(cells, rect[:, None, None, :])  # (B, gh, gw)
        region = (score > iou_thresh) & valid[:, i, None, None]
        cls = labels[:, i, None] == classes                # (B, C)
        hit = region[..., None] & cls[:, None, None, :]    # (B, gh, gw, C)
        hit4 = hit[..., None]
        corners = torch.stack([x - cells[..., 0], y - cells[..., 1],
                               (x + w) - cells[..., 0],
                               (y + h) - cells[..., 1]], dim=-1)
        inv = torch.stack([1.0 / w, 1.0 / h, 1.0 / w, 1.0 / h], dim=-1)
        coverage = torch.where(hit, 1.0, coverage)
        bbox = torch.where(hit4, corners[:, :, :, None, :], bbox)
        size = torch.where(hit4, inv[:, :, :, None, :], size)
        obj = torch.where(hit4, (cell_area / (w * h))[..., None, None], obj)
        cov_block = torch.where(hit4, 1.0, cov_block)
    return GridLabels(coverage=coverage,
                      bbox=bbox.reshape(b, gh, gw, 4 * c),
                      size=size.reshape(b, gh, gw, 4 * c),
                      obj=obj.reshape(b, gh, gw, 4 * c),
                      coverage_block=cov_block.reshape(b, gh, gw, 4 * c))


def encode_grid_labels(rects: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, grid: GridConfig,
                       iou_thresh: float = 0.1) -> GridLabels:
    """``encode_grid_labels_batch`` for one image: (M, 4), (M,), (M,) ->
    (gh, gw, C) / (gh, gw, 4C) grids."""
    out = encode_grid_labels_batch(rects[None], labels[None], valid[None],
                                   grid, iou_thresh)
    return GridLabels(*(t[0] for t in out))


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
