"""Box geometry of the port (``tpufcn/ops/boxes.py``), batched over any
leading dims.  Rects are ``(x, y, w, h)`` rows.

The reference's ``JaccardCoeff.iou`` (argumentation_engine.py:24-55), which
the label-grid encoder uses, has two quirks kept for parity: its
denominator is the area of the union's bounding box, and its result is
divided by the area ratio ``area(a) / area(b)``.
"""

from __future__ import annotations

import torch


def _area(rect: torch.Tensor) -> torch.Tensor:
    return rect[..., 2] * rect[..., 3]


def iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of the union's bounding box, 0 where the
    rects do not overlap (broadcasting, float32)."""
    a, b = a.float(), b.float()
    w = torch.minimum(a[..., 0] + a[..., 2], b[..., 0] + b[..., 2]) \
        - torch.maximum(a[..., 0], b[..., 0])
    h = torch.minimum(a[..., 1] + a[..., 3], b[..., 1] + b[..., 3]) \
        - torch.maximum(a[..., 1], b[..., 1])
    empty = (w < 0) | (h < 0)
    inter = torch.where(empty, 0.0, w) * torch.where(empty, 0.0, h)
    ux = torch.minimum(a[..., 0], b[..., 0])
    uy = torch.minimum(a[..., 1], b[..., 1])
    uw = torch.maximum(a[..., 0] + a[..., 2], b[..., 0] + b[..., 2]) - ux
    uh = torch.maximum(a[..., 1] + a[..., 3], b[..., 1] + b[..., 3]) - uy
    return torch.where(inter > 0, inter / (uw * uh), 0.0)


def scaled_iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference ``JaccardCoeff.iou``: ``iou_xywh(a, b) / (area(a) /
    area(b))``, 0 where the rects do not overlap."""
    base = iou_xywh(a, b)
    return torch.where(base > 0, base / (_area(a.float()) / _area(b.float())),
                       0.0)
