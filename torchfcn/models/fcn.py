"""FCN families (``tpufcn/models/fcn.py``): FCN-8s with a bbox branch and
FCN-32s segmentation, on the VGG16 backbone.

:class:`FCN8sBBox` (reference train/fcn_bbox/train_val.prototxt): VGG16 +
pool5; bbox branch ``score_conv5_bbox`` -> bilinear deconv k8 s4 p2 (stride
8); seg branch ``score_conv5`` -> up x2 + ``score_pool4`` -> up x2 +
``score_pool3`` = ``fuse3`` (stride 8) -> up k16 s8 p4 (full resolution).
``coverage`` is the float32 softmax of ``fuse3``; channel 0 is background,
which the Detector skips.

:class:`FCN32sSeg` (reference train/semantic_segmentation/train_val.prototxt):
VGG16 without pool5; ``score_fr_6`` on conv5_3 (stride 16) -> up k32 s16 p8.

Every bilinear deconvolution runs in its separable form, in float32 on
float32 scores (``models.layers.upsample_factor``).  Input: demeaned +
min-max BGR in [0, 1], NHWC.  FCN-8s drops pool5 out ("dropout5", rate
0.5) in train mode; FCN-32s has no dropout, as in the JAX package.

On a mesh with ``space > 1`` both run row-sharded (``models/layers.py``):
the backbone on each rank's band, pool5 (2x2/2) with no halo, and each
deconvolution through its band of the global row matrix with one halo row
above and below; every head comes out as the rank's rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from torchfcn.core.mesh import Mesh, check_band
from torchfcn.models.layers import (
    CaffeConv, ZooModel, dropout, max_pool, nchw, nhwc, upsample_factor)
from torchfcn.models.vgg import VGG16Backbone


def _score(conv: CaffeConv, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 score conv in the compute dtype -> float32 NCHW."""
    return conv(x.to(conv.dtype)).float()


class FCN8sBBox(ZooModel):
    """num_classes includes background (reference: 11)."""

    row_stride = 32          # pool5: the deepest stride

    def __init__(self, num_classes: int = 11,
                 store_dtype: Optional[torch.dtype] = None,
                 store_stages: int = 5, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        c = num_classes
        self.backbone = VGG16Backbone(store_dtype=store_dtype,
                                      store_stages=store_stages)
        self.score_conv5_bbox = CaffeConv(512, 4 * c, 1)
        self.score_conv5 = CaffeConv(512, c, 1)
        self.score_pool4 = CaffeConv(512, c, 1)
        self.score_pool3 = CaffeConv(256, c, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        check_band(x.shape[1], mesh, self.row_stride)
        taps = self.backbone(nchw(x), mesh)
        p5 = dropout(max_pool(taps["conv5_3"], 2, 2, mesh=mesh),  # stride 32
                     self.dropout_rate, self.training, generator, mesh)
        # bbox branch, stride 8
        bboxes = upsample_factor(_score(self.score_conv5_bbox, p5), 4, mesh)
        # seg branch: FCN-8s skip fusion
        up5 = upsample_factor(_score(self.score_conv5, p5), 2,
                              mesh)                        # stride 16
        fuse4 = up5 + _score(self.score_pool4, taps["pool4"])
        up4 = upsample_factor(fuse4, 2, mesh)              # stride 8
        fuse3 = up4 + _score(self.score_pool3, taps["pool3"])
        seg = upsample_factor(fuse3, 8, mesh)              # full resolution
        return {"coverage": torch.softmax(nhwc(fuse3), dim=-1),
                "bboxes": nhwc(bboxes), "seg": nhwc(seg)}


class FCN32sSeg(ZooModel):
    """num_classes includes background (reference: 12)."""

    row_stride = 16          # conv5_3: the deepest stride

    def __init__(self, num_classes: int = 12,
                 store_dtype: Optional[torch.dtype] = None,
                 store_stages: int = 5):
        super().__init__()
        self.backbone = VGG16Backbone(store_dtype=store_dtype,
                                      store_stages=store_stages)
        # the Caffe layer name (its top blob is "score_fr")
        self.score_fr_6 = CaffeConv(512, num_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        check_band(x.shape[1], mesh, self.row_stride)
        s = _score(self.score_fr_6, self.backbone(nchw(x), mesh)["conv5_3"])
        seg = nhwc(upsample_factor(s, 16, mesh))           # full resolution
        return {"seg": seg, "score": torch.softmax(seg, dim=-1)}
