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
float32 scores.  Input: demeaned + min-max BGR in [0, 1], NHWC.  FCN-8s
drops pool5 out ("dropout5", rate 0.5) in train mode; FCN-32s has no
dropout, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from torchfcn.core.mesh import Mesh
from torchfcn.models.layers import (
    CaffeConv, ZooModel, dropout, max_pool, nchw, nhwc, refuse_space)
from torchfcn.models.vgg import VGG16Backbone
from torchfcn.ops.caffe_layers import upsample_bilinear_separable


def _score(conv: CaffeConv, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 score conv in the compute dtype -> float32 NHWC."""
    return nhwc(conv(x.to(conv.dtype)).float())


class FCN8sBBox(ZooModel):
    """num_classes includes background (reference: 11)."""

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
        refuse_space(mesh, "FCN-8s")
        taps = self.backbone(nchw(x))
        p5 = dropout(max_pool(taps["conv5_3"], 2, 2),      # stride 32
                     self.dropout_rate, self.training, generator, mesh)
        # bbox branch, stride 8
        bboxes = upsample_bilinear_separable(
            _score(self.score_conv5_bbox, p5), 8, 4, 2)
        # seg branch: FCN-8s skip fusion
        up5 = upsample_bilinear_separable(_score(self.score_conv5, p5),
                                          4, 2, 1)         # stride 16
        fuse4 = up5 + _score(self.score_pool4, taps["pool4"])
        up4 = upsample_bilinear_separable(fuse4, 4, 2, 1)  # stride 8
        fuse3 = up4 + _score(self.score_pool3, taps["pool3"])
        seg = upsample_bilinear_separable(fuse3, 16, 8, 4)  # full resolution
        return {"coverage": torch.softmax(fuse3, dim=-1),
                "bboxes": bboxes, "seg": seg}


class FCN32sSeg(ZooModel):
    """num_classes includes background (reference: 12)."""

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
        refuse_space(mesh, "FCN-32s")
        s = _score(self.score_fr_6, self.backbone(nchw(x))["conv5_3"])
        seg = upsample_bilinear_separable(s, 32, 16, 8)    # full resolution
        return {"seg": seg, "score": torch.softmax(seg, dim=-1)}
