"""``Detector(mesh=...)`` row-sharded over 2 gloo CPU ranks for the FCN-8s,
VGG pyramid and ResNet-FPN families against the port's one-device
Detector on the same weights and frames, float32: per image the sorted
(box, label) lists equal and the confidences (log votes) within 1 float32
ulp, as ``test_torch_distributed_serving.py`` holds the GoogLeNet and VGG
Detectors; every rank returns the global result.  FCN-8s at its reference
288x288, whose bands are uneven (160 + 128 rows: 5 + 4 pool5 rows); the
pyramid at 448x448 (224 + 224); ResNet-FPN at 160x160 (96 + 64).  The heads
are biased (``torchfcn.serve.profile.bias_heads``) so that NMS has work,
and the DetectNet heads' weights scaled by 0.1 under a coverage bias of 8
so that cells fire together, as that file's GoogLeNet test does."""

import numpy as np
import pytest
import torch

from torchfcn.core.config import DetectorConfig, GridConfig
from torchfcn.models import get_spec
from torchfcn.parallel.distributed import run_ranks
from torchfcn.serve.detector import Detector
from torchfcn.serve.profile import bias_heads

from test_torch_distributed_serving import _result, _same_detections
from test_torch_mesh_ranks import rank_detector

torch.set_num_threads(2)


@pytest.mark.parametrize("name,hw,batch", [
    ("fcn8s_bbox", 288, 2),
    ("vgg_pyramid_detectnet", 448, 1),
    ("resnet_fpn_detectnet", 160, 2),
])
def test_row_sharded_detector_matches_one_device(name, hw, batch):
    spec = get_spec(name)
    grid = GridConfig(hw, hw, stride=spec.grid.stride, num_classes=3)
    cfg = DetectorConfig(grid=grid, model=name, max_candidates=64)
    det = Detector(name, config=cfg, dtype=torch.float32, device="cpu",
                   model_kwargs={"num_classes": 3})
    bias_heads(det)
    if hasattr(det.model, "cvg"):
        with torch.no_grad():
            det.model.cvg.weight.mul_(0.1)
            det.model.cvg.bias.fill_(8.0)
            det.model.bbox.weight.mul_(0.1)
    frames = np.random.default_rng(3).integers(
        0, 256, (batch, hw, hw, 3)).astype(np.uint8)
    one = det(frames)
    got = run_ranks(rank_detector, 2, name, det.model.state_dict(),
                    {"num_classes": 3}, cfg, frames, 1, 2, torch.float32,
                    threads=1)
    for parts in got:
        res = _result(parts)
        for a, b in zip(res, got[0]):
            assert torch.equal(a, b)        # every rank: the global result
        assert res.boxes.shape == one.boxes.shape
        _same_detections(res, one)
