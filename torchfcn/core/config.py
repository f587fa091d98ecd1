"""Configuration of the port.

A copy of ``IMAGENET_BGR_MEAN``, ``GridConfig``, ``DetectorConfig``,
``MeshConfig``, ``DataConfig`` and ``TrainConfig`` from
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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout: ``data`` (batch data-parallel) x ``space`` (spatial
    sharding).  The port trains and serves on one device so far; the
    Trainer refuses more."""

    data: int = 1
    space: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.space


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline configuration (reference data layer param_str and
    LMDB writer rosparams)."""

    manifest: Optional[str] = None       # train.txt path
    batch_size: int = 32
    shuffle_seed: int = 0
    num_compose: Tuple[int, int] = (1, 3)   # min/max pasted objects per scene
    compose_iou_thresh: float = 0.05        # paste overlap rejection threshold
    compose_max_trials: int = 100           # bounded rejection sampling
    scale_range: Tuple[float, float] = (1.0, 2.2)  # paste rescale range
    prefetch: int = 2
    add_background_class: bool = True
    # the reference's +/-5 deg rotation augmentation is gated off upstream
    rotate: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Solver configuration.  Defaults follow the reference ADAM recipe
    (train/bounding_box/solver.prototxt); the SGD recipe of fcn_bbox and
    semantic_segmentation is ``optimizer="sgd"``."""

    grid: GridConfig = dataclasses.field(default_factory=lambda: GridConfig(
        im_width=224, im_height=224, stride=8, num_classes=11))
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    model: str = "vgg_detectnet_train"
    optimizer: str = "adam"            # "adam" | "sgd"
    # Caffe gradient accumulation: one update per iter_size micro-batches,
    # with the mean of their gradients
    iter_size: int = 1
    learning_rate: float = 1e-4
    lr_decay_step: int = 10000         # step lr schedule: gamma every N iters
    lr_gamma: float = 0.1
    # linear lr warmup over the first N steps (0 = off, the Caffe default);
    # the decay boundaries count from its end
    warmup_steps: int = 0
    momentum: float = 0.9
    weight_decay: float = 1e-7
    max_iter: int = 100000
    snapshot_every: int = 5000
    snapshot_dir: str = "snapshots"
    # every N steps Trainer.fit runs its validator and keeps the best
    # snapshot in <snapshot_dir>/best; 0 = off
    eval_every: int = 0
    bbox_loss_weight: float = 2.0      # models/train_val.prototxt:2264
    coverage_loss_weight: float = 1.0
    seg_loss_weight: float = 1.0
    log_every: int = 20                # reference solver display: 20
    seed: int = 0
