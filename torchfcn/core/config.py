"""Serving configuration of the port.

A copy of ``IMAGENET_BGR_MEAN``, ``GridConfig`` and ``DetectorConfig`` from
``tpufcn/core/config.py``, with the same fields and defaults.  They are copied
and not imported because importing ``tpufcn.core.config`` runs
``tpufcn/core/__init__.py``, which imports ``core/mesh.py`` and
``core/dtypes.py`` and with them JAX; the port must import without JAX and the
reference package stays unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# ImageNet BGR channel means (reference scripts/fcn_object_detector.py:407-413).
IMAGENET_BGR_MEAN: Tuple[float, float, float] = (
    104.0069879317889,
    116.66876761696767,
    122.6789143406786,
)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Geometry of the DetectNet decode grid (``w,h,stride,num_classes``)."""

    im_width: int = 448
    im_height: int = 448
    stride: int = 8
    num_classes: int = 1  # foreground classes (background handled separately)

    @property
    def grid_w(self) -> int:
        return self.im_width // self.stride

    @property
    def grid_h(self) -> int:
        return self.im_height // self.stride

    @property
    def cell_w(self) -> int:
        return self.im_width // self.grid_w

    @property
    def cell_h(self) -> int:
        return self.im_height // self.grid_h


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Inference-time detector parameters (reference rosparams defaults)."""

    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    detection_threshold: float = 0.5  # coverage mask threshold
    min_boxes: int = 3                # groupRectangles groupThreshold
    nms_eps: float = 0.2              # groupRectangles eps
    min_box_height: int = 20          # reject grouped rect if y2-y1 < this
    model: str = "googlenet_detectnet"
    # Candidate cells per class fed to box grouping; None keeps the full
    # grid capacity (grid_h * grid_w), as the reference does.
    max_candidates: Optional[int] = None

    @property
    def candidate_capacity(self) -> int:
        if self.max_candidates is not None:
            return self.max_candidates
        return self.grid.grid_h * self.grid.grid_w
