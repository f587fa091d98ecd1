"""ResNet-18 + FPN DetectNet (``tpufcn/models/resnet_fpn.py``), the zoo's
modern-backbone swap.

* ResNet-18 basic blocks with bias-free convs and GroupNorm (32 groups,
  float32 on the conv output, epsilon 1e-6 as in Flax);
* a 7x7/2 stem conv + GroupNorm, then a 3x3/2 max pool with padding 1
  (floor mode, the padding is -inf);
* an FPN top-down path to P4 (stride 16): lateral 1x1 convs on C5 and C4,
  nearest x2 of P5, a 3x3 smoothing conv with ReLU;
* the DetectNet heads: 1x1 sigmoid coverage and 1x1 bbox regressor.

Input: raw BGR in [0, 255], normalised to (x - 127) / 128 in float32 before
the cast to the compute dtype (the parameters').  With ``store_dtype``
(float8_e5m2) the stem's output and every block's output are stored in it,
after the GroupNorm statistics; convs read them widened to the compute
dtype.  Dropout ("drop", rate 0.1) on P4 acts in train mode only.

On a mesh with ``space > 1`` it runs row-sharded (``models/layers.py``):
the stem conv reads 3 halo rows above and 2 below, the pool 1 above, each
3x3 conv 1 above (and 1 below at stride 1); the 1x1 shortcuts and the
nearest x2 of P5 need none, and each GroupNorm sums its statistics over
the space group.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from torchfcn.core.mesh import Mesh, check_band
from torchfcn.models.layers import (
    CaffeConv, Conv, GroupNorm, ZooModel, check_store_dtype, dropout,
    max_pool_floor, nchw, nhwc)


class BasicBlock(nn.Module):
    """3x3 + 3x3 with an identity shortcut, or a 1x1 (strided) conv +
    GroupNorm shortcut where the stride or the width changes."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 store_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.store_dtype = store_dtype
        self.conv1 = Conv(cin, features, 3, stride, 1)
        self.gn1 = GroupNorm(features)
        self.conv2 = Conv(features, features, 3, 1, 1)
        self.gn2 = GroupNorm(features)
        if stride != 1 or cin != features:
            self.down = Conv(cin, features, 1, stride)
            self.gn_down = GroupNorm(features)
        else:
            self.down = None

    def forward(self, x: torch.Tensor,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        dtype = self.conv1.dtype
        xc = x.to(dtype)
        y = F.relu(self.gn1(self.conv1(xc, mesh), mesh)).to(dtype)
        y = self.gn2(self.conv2(y, mesh), mesh)            # float32
        residual = x if self.down is None \
            else self.gn_down(self.down(xc), mesh)
        out = F.relu(y + residual.to(y.dtype)).to(dtype)
        return out if self.store_dtype is None else out.to(self.store_dtype)


class ResNetFPNDetectNet(ZooModel):
    """ResNet-18 + FPN -> stride-16 DetectNet heads.

    Returns {"coverage": (B, H/16, W/16, C) float32 sigmoid probabilities,
             "bboxes": (B, H/16, W/16, 4C) float32 corner offsets}, NHWC.
    """

    FLAX_NAMES = {"cvg": "cvg/classifier", "bbox": "bbox/regressor"}
    row_stride = 32          # C5: the deepest stride

    def __init__(self, num_classes: int = 4,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 fpn_channels: int = 256,
                 store_dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        check_store_dtype(store_dtype)
        self.store_dtype = store_dtype
        self.stem_conv = Conv(3, 64, 7, 2, 3)
        self.stem_gn = GroupNorm(64)
        self.stages = []
        cin = 64
        for si, (n, w) in enumerate(zip(stage_sizes, widths)):
            names = []
            for bi in range(n):
                stride = 2 if bi == 0 and si > 0 else 1
                name = f"stage{si + 1}_block{bi}"
                self.add_module(name, BasicBlock(cin, w, stride, store_dtype))
                names.append(name)
                cin = w
            self.stages.append(names)
        f = fpn_channels
        self.lat5 = CaffeConv(widths[3], f, 1)
        self.lat4 = CaffeConv(widths[2], f, 1)
        self.smooth4 = CaffeConv(f, f, 3, pad=1)
        self.cvg = CaffeConv(f, num_classes, 1)
        self.bbox = CaffeConv(f, 4 * num_classes, 1)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        check_band(frames.shape[1], mesh, self.row_stride)
        dtype = self.stem_conv.dtype
        x = nchw(((frames.to(torch.float32) - 127.0) / 128.0).to(dtype))
        y = F.relu(self.stem_gn(self.stem_conv(x, mesh), mesh)).to(dtype)
        if self.store_dtype is not None:
            y = y.to(self.store_dtype)
        y = max_pool_floor(y, 3, 2, 1, mesh)               # stride 4
        taps = []
        for names in self.stages:                          # C2 (s4) .. C5
            for name in names:
                y = getattr(self, name)(y, mesh)
            taps.append(y)
        c4, c5 = taps[2], taps[3]
        # FPN top-down to P4 (stride 16): nearest x2 of P5
        p5 = nhwc(self.lat5(c5.to(dtype)))
        up5 = nchw(p5.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        p4 = F.relu(self.smooth4(self.lat4(c4.to(dtype)) + up5, mesh))
        p4 = dropout(p4, self.dropout_rate, self.training, generator, mesh)
        coverage = torch.sigmoid(self.cvg(p4).float())
        bboxes = self.bbox(p4).float()
        return {"coverage": nhwc(coverage).contiguous(),
                "bboxes": nhwc(bboxes).contiguous()}
