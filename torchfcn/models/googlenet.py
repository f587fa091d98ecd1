"""GoogLeNet (Inception-v1) DetectNet, the flagship detection model
(``tpufcn/models/googlenet.py``; reference models/deploy.prototxt).

Structure kept from the reference deploy graph:

* ``Power shift:-127`` on raw 0..255 BGR pixels;
* conv1 7x7/2, ceil-mode pool1, LRN (pool1/norm1), conv2 1x1 then 3x3, LRN
  (conv2/norm2) and pool2 (fused into one kernel here);
* nine inception blocks with **no** pool between inception_4e and
  inception_5a, so the output grid has stride 16 (448x448 -> 28x28);
* dropout pool5/drop_s1 (rate 0.4) in train mode, 1x1 coverage head with
  sigmoid and 1x1 bbox head.

conv1 is the plain stride-2 conv: the JAX package's space-to-depth form is a
TPU lane-packing trick that ``tests/test_fast_conv.py`` pins identical to it.
Compute runs in the convs' dtype (bf16 for serving, float32 for parity).

The fp8 serving preset (``store_dtype=torch.float8_e5m2`` with
``store_stem2``, ``tpufcn/models/googlenet.py:161-200``) stores activations
in e5m2 and computes in bf16: conv1's output, pool1's, the stem tail's (LRN1
through pool2, one ``stem_tail`` kernel whose intermediates stay on the
chip) and, with ``store_blocks``, the inception branches and concats.  Pools
on e5m2 run through bf16 and stay e5m2 (the max is exact); convs read their
e5m2 input widened to bf16.  Without ``store_stem2`` (the JAX model's
default) only conv1, pool1 and LRN1 are stored e5m2: LRN1 runs the ``lrn``
kernel on pool1's values widened to bf16, and conv2_reduce, conv2 and the
fused LRN2 + pool2 stay bf16, as on the bf16 path.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from torchfcn.core.mesh import Mesh, check_band, space_sharded
from torchfcn.models.layers import (
    CaffeConv, LRN, LRNMaxPool, ZooModel, dropout, max_pool, nchw, nhwc)
from torchfcn.ops.cuda.stem import stem_tail_cuda
from torchfcn.parallel.halo import attached, halo_rows

# Inception block widths: (1x1, 3x3_reduce, 3x3, 5x5_reduce, 5x5, pool_proj)
INCEPTION_CFG = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


class Inception(nn.Module):
    """One inception module.  The three 1x1 convs that read the block input
    run as one conv over their concatenated kernels (one larger GEMM); the
    parameters stay three Caffe convs, as in the JAX package.  With
    ``store_dtype`` the fused 1x1 output and the 3x3, 5x5 and pool branches
    are stored in it, and so is the concat."""

    def __init__(self, cin: int, n1: int, n3r: int, n3: int, n5r: int,
                 n5: int, npp: int, store_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.store_dtype = store_dtype
        self.b1x1 = CaffeConv(cin, n1, 1)
        self.b3x3_reduce = CaffeConv(cin, n3r, 1)
        self.b3x3 = CaffeConv(n3r, n3, 3, pad=1)
        self.b5x5_reduce = CaffeConv(cin, n5r, 1)
        self.b5x5 = CaffeConv(n5r, n5, 5, pad=2)
        self.pool_proj = CaffeConv(cin, npp, 1)
        self.widths = (n1, n3r, n5r)
        self.out_channels = n1 + n3 + n5 + npp

    def _store(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.store_dtype is None else x.to(self.store_dtype)

    def forward(self, x: torch.Tensor,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        dtype = self.b1x1.dtype
        x = x.to(dtype)            # e5m2 input widens exactly
        convs = (self.b1x1, self.b3x3_reduce, self.b5x5_reduce)
        y = self._store(F.relu(F.conv2d(
            x, torch.cat([c.weight for c in convs]).to(dtype),
            torch.cat([c.bias for c in convs]).to(dtype))))
        b1, b3, b5 = torch.split(y, self.widths, dim=1)
        b3 = self._store(F.relu(self.b3x3(b3.to(dtype), mesh)))
        b5 = self._store(F.relu(self.b5x5(b5.to(dtype), mesh)))
        bp = self._store(F.relu(self.pool_proj(max_pool(x, 3, 1, 1, mesh))))
        return torch.cat([b1, b3, b5, bp], dim=1)


class GoogLeNetDetectNet(ZooModel):
    """Input: raw BGR frames (B, H, W, 3), uint8 or float in [0, 255].

    Returns {"coverage": (B, H/16, W/16, C) float32 sigmoid probabilities,
             "bboxes": (B, H/16, W/16, 4C) float32 corner offsets}, NHWC.

    ``mesh``: on a (data, space) mesh, ``frames`` are this rank's batch
    shard and, with ``space > 1``, its band of rows (``core.mesh.
    row_bands``: a multiple of 16 above the frame's last band), and the
    outputs are this rank's rows of the heads.
    """

    row_stride = 16          # the deepest stride: an inner band's rows divide

    FLAX_NAMES = {
        "conv1": "conv1/7x7_s2", "conv2_reduce": "conv2/3x3_reduce",
        "conv2": "conv2/3x3", "cvg": "cvg/classifier",
        "bbox": "bbox/regressor",
        # inception branches
        "b1x1": "1x1", "b3x3_reduce": "3x3_reduce", "b3x3": "3x3",
        "b5x5_reduce": "5x5_reduce", "b5x5": "5x5",
    }

    def __init__(self, num_classes: int = 4,
                 store_dtype: Optional[torch.dtype] = None,
                 store_blocks: bool = False, store_stem2: bool = False,
                 dropout_rate: float = 0.4):
        super().__init__()
        self.dropout_rate = dropout_rate       # deploy.prototxt pool5/drop_s1
        if store_dtype not in (None, torch.float8_e5m2):
            raise ValueError(f"store_dtype must be None or float8_e5m2 "
                             f"(e4m3 saturates conv1), got {store_dtype}")
        # as in the JAX model, the store_* flags do nothing without a dtype
        self.store_dtype = store_dtype
        self.store_stem2 = store_stem2
        self.conv1 = CaffeConv(3, 64, 7, stride=2, pad=3)
        self.norm1 = LRN()
        self.conv2_reduce = CaffeConv(64, 64, 1)
        self.conv2 = CaffeConv(64, 192, 3, pad=1)
        self.norm2_pool2 = LRNMaxPool()
        cin = 192
        block_store = store_dtype if store_blocks else None
        for name, widths in INCEPTION_CFG.items():
            block = Inception(cin, *widths, store_dtype=block_store)
            self.add_module(f"inception_{name}", block)
            cin = block.out_channels
        self.cvg = CaffeConv(cin, num_classes, 1)
        self.bbox = CaffeConv(cin, 4 * num_classes, 1)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        check_band(frames.shape[1], mesh, self.row_stride)
        dtype = self.conv1.dtype
        store = self.store_dtype
        if store is not None and dtype != torch.bfloat16:
            raise ValueError(f"e5m2 storage computes in bfloat16, the "
                             f"parameters are {dtype}")
        # deploy_transform: Power shift -127 (deploy.prototxt:9-18)
        x = nchw((frames.to(torch.float32) - 127.0).to(dtype))
        x = F.relu(self.conv1(x, mesh))
        if store is None or not self.store_stem2:
            if store is None:
                x = max_pool(x, 3, 2, mesh=mesh)           # pool1/3x3_s2
                x = self.norm1(x)                          # pool1/norm1
            else:
                # pool1 stays e5m2 (the max is exact); LRN1 computes on its
                # values widened to bf16 and is stored e5m2
                x = max_pool(x.to(store), 3, 2, mesh=mesh)
                x = self.norm1(x.to(dtype)).to(store)
            x = F.relu(self.conv2_reduce(x.to(dtype)))
            x = F.relu(self.conv2(x, mesh))
            x = self.norm2_pool2(x, mesh)      # conv2/norm2 + pool2/3x3_s2
        else:
            x = max_pool(x.to(store), 3, 2, mesh=mesh)   # pool1, e5m2
            # pool1/norm1 .. pool2/3x3_s2 in one kernel, e5m2 in and out;
            # on a row shard with conv2's halo above and conv2's and the
            # pool's below, which the kernel reads as data
            top, bottom = attached(1, 2, mesh, None) \
                if space_sharded(mesh) else (0, 0)
            x = halo_rows(x, 1, 2, mesh, fill=None)
            x = nchw(stem_tail_cuda(
                nhwc(x).contiguous(), self.conv2_reduce.weight,
                self.conv2_reduce.bias, self.conv2.weight, self.conv2.bias,
                store, top, bottom))
        x = self.inception_3a(x, mesh)
        x = self.inception_3b(x, mesh)
        x = max_pool(x, 3, 2, mesh=mesh)                   # pool3/3x3_s2
        for blk in ("4a", "4b", "4c", "4d", "4e", "5a", "5b"):
            # no pool between 4e and 5a: the stride stays 16
            x = getattr(self, f"inception_{blk}")(x, mesh)
        x = dropout(x.to(dtype), self.dropout_rate, self.training, generator,
                    mesh)
        coverage = torch.sigmoid(self.cvg(x).float())
        bboxes = self.bbox(x).float()
        return {"coverage": nhwc(coverage).contiguous(),
                "bboxes": nhwc(bboxes).contiguous()}
