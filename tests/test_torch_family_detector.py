"""The port's Detector over the VGG, FCN and ResNet-FPN families, and its
segmentation surface, against tpufcn's on the same weights in float32.

The heads are biased on the shared JAX tree so that cells fire with boxes
tall enough to pass the NMS height filter: coverage bias 1 and bbox bias
(-24, -24, 120, 120) per class (corner boxes read as (x, y, w, h):
neighbouring cells are similar), and for FCN-8s a foreground class (1) whose
``score_pool3`` bias of 4 lifts its softmax above 0.5, with the bbox bias
on ``score_conv5_bbox`` before its k8 upsample.  Per (image, class) the
(box, label) lists must be equal and the confidences within 1 ulp (XLA's
CPU float32 log, as in tests/test_torch_detector.py).  Segment labels must
equal tpufcn's argmax wherever the top two logits are further apart than
1e-5 of the logits' scale (the f32 forwards agree to 3e-6 of it)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import DetectorConfig as JaxDetectorConfig
from tpufcn.core.config import GridConfig as JaxGridConfig
from tpufcn.models import build as jax_build
from tpufcn.ops.image import demean_bgr as jax_demean
from tpufcn.serve import detector as jax_det
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DetectorConfig, GridConfig
from torchfcn.serve.detector import Detector
from torchfcn.serve.segment import Segmenter

from golden import golden_vote_boxes

torch.set_num_threads(2)

BOX = np.float32([-24, -24, 120, 120])
# model: (net size, stride, classes incl. background), small grids
CASES = {
    "vgg_detectnet_train": (64, 8, 11),
    "fcn8s_bbox": (96, 8, 11),
    "resnet_fpn_detectnet": (128, 16, 4),
}


def _biased(params, name, classes):
    """A copy of the numpy tree with the heads biased (see the module
    docstring)."""
    params = jax.tree.map(np.array, params)
    p = params["params"]
    if name.startswith("fcn8s"):
        p["score_pool3"]["conv"]["bias"][1] = 4.0
        p["score_conv5_bbox"]["conv"]["bias"][:] = np.tile(BOX, classes)
    else:
        p["cvg/classifier"]["conv"]["bias"][:] = 1.0
        p["bbox/regressor"]["conv"]["bias"][:] = np.tile(BOX, classes)
    return params


def _detectors(name):
    hw, stride, classes = CASES[name]
    jgrid = JaxGridConfig(hw, hw, stride=stride, num_classes=classes)
    jdet = jax_det.Detector(name, dtype=jnp.float32, config=JaxDetectorConfig(
        grid=jgrid, model=name), rng_seed=0)
    params = _biased(jdet.params, name, classes)
    jdet.params = jax.tree.map(jnp.asarray, params)
    det = Detector(name, dtype=torch.float32, device="cpu",
                   config=DetectorConfig(
                       grid=GridConfig(hw, hw, stride=stride,
                                       num_classes=classes), model=name))
    load_jax_params(det.model, params)
    return jdet, det


def _assert_same_detections(got, want):
    got_lists, want_lists = got.to_lists(), want.to_lists()
    assert sum(map(len, got_lists)) > 0
    for g_img, w_img in zip(got_lists, want_lists):
        g_img, w_img = sorted(g_img), sorted(w_img)
        assert [d[:2] for d in g_img] == [d[:2] for d in w_img]
        np.testing.assert_array_max_ulp(
            np.float32([d[2] for d in g_img]),
            np.float32([d[2] for d in w_img]), maxulp=1)


@pytest.mark.parametrize("name", list(CASES))
def test_detector_matches_jax(rng, name):
    """At the net's size and on frames of another size (demeaned at their
    own size, then resized, for the demean families)."""
    hw = CASES[name][0]
    jdet, det = _detectors(name)
    for shape in ((2, hw, hw, 3), (1, hw + 24, hw - 16, 3)):
        frames = rng.integers(0, 256, shape).astype(np.uint8)
        got, want = det(frames), jdet(frames)
        assert got.boxes.shape == tuple(np.asarray(want.boxes).shape)
        _assert_same_detections(got, want)


def test_fcn8s_detector_skips_background(rng):
    """Only the 10 foreground classes are decoded, class k with bbox block
    k; the background channel (0) fires everywhere and is not decoded."""
    _, det = _detectors("fcn8s_bbox")
    frames = rng.integers(0, 256, (1, 96, 96, 3)).astype(np.uint8)
    got = det(frames)
    assert got.valid.shape == (1, 10, 144)
    assert got.valid[0, 0].any() and not got.valid[0, 1:].any()


def test_model_kwargs_set_classes_and_storage():
    det = Detector("resnet_fpn_detectnet", device="cpu", model_kwargs={
        "num_classes": 2, "store_dtype": torch.float8_e5m2})
    assert det.grid.num_classes == 2 and det.model.cvg.out_channels == 2
    assert det.model.store_dtype == torch.float8_e5m2
    res = det(np.zeros((1, 448, 448, 3), np.uint8))
    assert res.boxes.shape == (1, 2, 784, 4)
    with pytest.raises(ValueError, match="Segmenter"):
        Detector("fcn32s_seg", device="cpu")


def test_default_capacity_runs_the_plain_nms_at_1296(rng):
    """fcn8s_bbox at its native 288x288 keeps all 36 x 36 = 1296 cells per
    class (the kernel's old limit was 1024): on the CPU the plain version
    groups them, as the numpy golden does."""
    det = Detector("fcn8s_bbox", dtype=torch.float32, device="cpu")
    with torch.no_grad():
        det.model.score_pool3.bias[1] = 4.0
        det.model.score_conv5_bbox.bias.copy_(torch.from_numpy(
            np.tile(BOX, 11)))
    frames = rng.integers(0, 256, (1, 288, 288, 3)).astype(np.uint8)
    got = det(frames)
    assert got.boxes.shape == (1, 10, 1296, 4)
    with torch.inference_mode():
        cov, boxes = det._forward(torch.from_numpy(frames))
    valid = cov[0, ..., 1] >= 0.5
    assert int(valid.sum()) > 1024
    # all valid cells of class 1, in cell order (K covers the whole grid)
    gy, gx = torch.meshgrid(torch.arange(36) * 8, torch.arange(36) * 8,
                            indexing="ij")
    origin = torch.stack([gx, gy, gx, gy], -1).float()
    cells = (boxes[0, ..., 4:8] + origin)[valid]
    cells = torch.clamp(torch.round(cells), -2048, 2047).numpy()
    want = sorted((list(map(int, d[:4])), float(np.float32(d[4])))
                  for d in golden_vote_boxes(cells, 3, 0.2, 20))
    v = got.valid[0, 0]
    have = sorted((b, float(c)) for b, c in zip(got.boxes[0, 0][v].tolist(),
                                                got.confidence[0, 0][v]))
    assert have and have == want


def test_segmenter_matches_jax_argmax(rng):
    hw = 64
    model = jax_build("fcn32s_seg", dtype=jnp.float32)
    params = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, hw, hw, 3), jnp.float32)))
    frames = rng.integers(0, 256, (2, hw, hw, 3)).astype(np.uint8)
    logits = np.asarray(jax.jit(model.apply)(
        params, jax_demean(jnp.asarray(frames, jnp.float32)))["seg"])
    want = logits.argmax(-1)
    seg = Segmenter("fcn32s_seg", dtype=torch.float32, device="cpu")
    load_jax_params(seg.model, params)
    got = seg(frames)
    assert got.shape == (2, hw, hw) and got.dtype == torch.int64
    top2 = np.sort(logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5 * np.abs(logits).max()
    assert clear.mean() > 0.99
    assert np.array_equal(got.numpy()[clear], want[clear])
    with pytest.raises(ValueError, match="segmentation"):
        Segmenter("vgg_detectnet_train", device="cpu")
