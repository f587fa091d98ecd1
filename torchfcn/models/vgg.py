"""VGG16-backbone DetectNet variants (``tpufcn/models/vgg.py``).

* :class:`VGGDetectNet`, the reference bounding_box training net
  (train/bounding_box/train_val.prototxt): conv5_3 -> fixed bilinear x2
  upsample -> 1x1 coverage (sigmoid) and bbox heads at stride 8.
* :class:`VGGPyramidDetectNet`, its deploy net
  (train/bounding_box/deploy.prototxt): spatial pyramid pooling of conv4_3
  (adaptive 1/2/4/7-bin average pools -> 1x1 conv to 128 -> bilinear
  upsample to the conv5_3 grid), concatenated as [conv5_3, pool4, up1,
  up2, up4, up7], heads at stride 16.  conv5_3 has no ReLU in this net.

Input: demeaned + min-max BGR in [0, 1] (``torchfcn.ops.image.demean_bgr``),
NHWC.  Dropout ("dropout5", rate 0.5) before the heads acts in train
mode only.  Compute runs in the convs' dtype.

On a mesh with ``space > 1`` both nets run row-sharded
(``models/layers.py``): each rank's band of rows in and out.  The
pyramid's pools read the whole conv4_3 map: each rank sums its rows of
every window, the sums are summed over the space group, and each rank
upsamples its rows of the bins x bins map (``pyramid_pool``).

With ``store_dtype`` (float8_e5m2) the conv outputs of the backbone stages
up to ``store_stages`` are stored in it; max pools run through bf16 and stay
e5m2 (the max is exact); every conv reads its input widened to the compute
dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from torchfcn.core.mesh import Mesh, check_band, space_sharded
from torchfcn.models.layers import (
    CaffeConv, ZooModel, check_store_dtype, dropout, max_pool, nchw, nhwc,
    row_band, upsample_factor, upsample_rows)
from torchfcn.parallel.distributed import all_reduce_sum

# VGG16 conv stack: (stage, n_convs, width)
VGG_STAGES = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))
PYRAMID_BINS = (1, 2, 4, 7)
HEAD_NAMES = {"cvg": "cvg/classifier", "bbox": "bbox/regressor"}


class VGG16Backbone(ZooModel):
    """conv1_1 .. conv5_3 with k2/s2 ceil-mode pools after stages 1-4.

    Returns the taps pool3, conv4_3, pool4 and conv5_3 (and the others),
    NCHW.  ``relu5_3=False`` drops conv5_3's ReLU (the pyramid deploy net).
    As a model of its own (the label tools' CNN codes) its Flax paths and
    Caffe layer names are the JAX package's ``VGG16Backbone``'s:
    ``conv1_1`` .. ``conv5_3``.
    """

    def __init__(self, relu5_3: bool = True,
                 store_dtype: Optional[torch.dtype] = None,
                 store_stages: int = 5):
        super().__init__()
        check_store_dtype(store_dtype)
        self.relu5_3 = relu5_3
        self.store_dtype, self.store_stages = store_dtype, store_stages
        cin = 3
        for stage, n_convs, width in VGG_STAGES:
            for i in range(1, n_convs + 1):
                self.add_module(f"conv{stage}_{i}",
                                CaffeConv(cin, width, 3, pad=1))
                cin = width

    def forward(self, x: torch.Tensor,
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        dtype = self.conv1_1.dtype
        taps = {}
        for stage, n_convs, _ in VGG_STAGES:
            for i in range(1, n_convs + 1):
                x = getattr(self, f"conv{stage}_{i}")(x.to(dtype), mesh)
                if stage < 5 or i < 3 or self.relu5_3:
                    x = F.relu(x)
                if self.store_dtype is not None and stage <= self.store_stages:
                    x = x.to(self.store_dtype)
            taps[f"conv{stage}_{n_convs}"] = x
            if stage < 5:
                x = max_pool(x, 2, 2, mesh=mesh)
                taps[f"pool{stage}"] = x
        return taps


class _Heads(ZooModel):
    """The DetectNet heads shared by both nets: 1x1 coverage (sigmoid,
    float32) and 1x1 bbox regressor (float32), NHWC out."""

    FLAX_NAMES = HEAD_NAMES

    def _heads(self, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = y.to(self.cvg.dtype)
        coverage = torch.sigmoid(self.cvg(y).float())
        bboxes = self.bbox(y).float()
        return {"coverage": nhwc(coverage).contiguous(),
                "bboxes": nhwc(bboxes).contiguous()}


def pyramid_pool(x: torch.Tensor, kernel: int, first: int, total: int):
    """The Caffe ceil-mode ``kernel`` x ``kernel`` average pool (stride
    ``kernel``, no padding) of an NCHW map of ``total`` rows, of which
    ``x`` holds the rows from ``first`` on: -> (this band's share of every
    window's sum, Caffe's divisor: the window's size clipped to the map),
    both float64 (the sums exact for bf16 inputs).  The shares of every
    band of the map add up to the whole map's sums."""
    rows, cols = x.shape[-2:]

    def windows(start, span, n):
        """The (windows, span) 0/1 matrix whose entry (j, i) is 1 where
        input row start + i lies in window j, and the windows' sizes."""
        j = np.arange(-(-n // kernel))
        return torch.from_numpy(
            j[:, None] == (start + np.arange(span))[None, :] // kernel
        ).to(x.device, torch.float64), np.minimum(j * kernel + kernel,
                                                  n) - j * kernel

    wy, ny = windows(first, rows, total)
    wx, nx = windows(0, cols, cols)
    sums = torch.einsum("jh,bchw,kw->bcjk", wy, x.to(torch.float64), wx)
    return sums, torch.from_numpy(np.outer(ny, nx)).to(x.device,
                                                       torch.float64)


class VGGDetectNet(_Heads):
    """Reference bounding_box train net head (stride 8).  On a mesh with
    ``space > 1`` it runs row-sharded (``models/layers.py``)."""

    row_stride = 16

    def __init__(self, num_classes: int = 11,
                 store_dtype: Optional[torch.dtype] = None,
                 store_stages: int = 5, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.backbone = VGG16Backbone(store_dtype=store_dtype,
                                      store_stages=store_stages)
        self.cvg = CaffeConv(512, num_classes, 1)
        self.bbox = CaffeConv(512, 4 * num_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        check_band(x.shape[1], mesh, self.row_stride)
        dtype = self.cvg.dtype
        y = self.backbone(nchw(x), mesh)["conv5_3"]        # stride 16
        y = upsample_factor(y.to(dtype), 2, mesh)          # stride 8
        return self._heads(dropout(y, self.dropout_rate, self.training,
                                   generator, mesh))


class VGGPyramidDetectNet(_Heads):
    """Reference bounding_box deploy net with spatial pyramid pooling
    (stride 16).  The pyramid closes at 448x448 input (conv4_3 56x56)."""

    row_stride = 16

    FLAX_NAMES = {**HEAD_NAMES, **{f"pyramid{b}": f"conv4_3/{b}x{b}"
                                   for b in PYRAMID_BINS}}

    def __init__(self, num_classes: int = 20,
                 store_dtype: Optional[torch.dtype] = None,
                 store_stages: int = 5, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.backbone = VGG16Backbone(relu5_3=False, store_dtype=store_dtype,
                                      store_stages=store_stages)
        for bins in PYRAMID_BINS:
            self.add_module(f"pyramid{bins}", CaffeConv(512, 128, 1))
        width = 512 + 512 + 128 * len(PYRAMID_BINS)
        self.cvg = CaffeConv(width, num_classes, 1)
        self.bbox = CaffeConv(width, 4 * num_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        check_band(x.shape[1], mesh, self.row_stride)
        dtype = self.cvg.dtype
        taps = self.backbone(nchw(x), mesh)
        # the pools sum the compute dtype's values, exactly
        c43 = taps["conv4_3"].to(dtype).to(torch.float64)  # stride 8
        rows = c43.shape[-2]
        # this band's first row and the whole map's rows
        first, s = row_band(rows, mesh) if space_sharded(mesh) else (0, rows)
        half = s // 2                                  # the stride-16 grid
        band = slice(first // 2, first // 2 + taps["conv5_3"].shape[-2])
        pyramid = []
        for bins in PYRAMID_BINS:
            k = math.ceil(s / bins)                    # adaptive pool kernel
            sums, div = pyramid_pool(c43, k, first, s)
            if space_sharded(mesh):
                sums = all_reduce_sum(sums, mesh.space_group)
            p = (sums / div).to(dtype)                 # (bins, bins)
            p = F.relu(getattr(self, f"pyramid{bins}")(p))
            pyramid.append(upsample_rows(p, half // p.shape[-2], band))
        # one dtype for the concat: e5m2 when the whole backbone is stored
        # in it, else the compute dtype
        store = self.backbone.store_dtype
        cat_dtype = store \
            if store is not None and self.backbone.store_stages >= 5 \
            else dtype
        y = torch.cat([t.to(cat_dtype) for t in
                       [taps["conv5_3"], taps["pool4"]] + pyramid], dim=1)
        return self._heads(dropout(y, self.dropout_rate, self.training,
                                   generator, mesh))
