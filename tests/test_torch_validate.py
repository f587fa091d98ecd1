"""torchfcn's evaluation and validators (``torchfcn/train/evaluate.py``,
``torchfcn/train/validate.py``) against tpufcn's.

* ``evaluate_detections`` (both AP metrics) and ``evaluate_segmentation``
  equal tpufcn's on seeded inputs, every field;
* ``score_detection`` gives tpufcn's mAP and detection count exactly, with
  float32 Detectors on both sides (vgg_detectnet_train at 64x64, 3
  classes), the same weights through ``load_jax_params`` and heads biased
  so that cells fire, over 10 held-out scenes composed by the port's own
  compositor in chunks of 4 (tpufcn pads the last chunk, the port does
  not), every other image's GT replaced by shifted copies of the boxes
  found there so that the mAP lies strictly between 0 and 1; the port's
  ``detection_validator`` on the same model gives the same numbers;
* ``seg_validator`` gives tpufcn's mIoU and pixel accuracy (fcn32s_seg at
  64x64 in float32, tpufcn's spec grid set to 64x64 so that it does not
  resize); a float32 argmax may flip at a near-tie, so both within
  SEG_ATOL;
* the held-out sets from manifests decode with the caller's imread and
  resize.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpufcn.models
from tpufcn.core.config import DetectorConfig as JDetectorConfig
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.serve import detector as jax_det
from tpufcn.train import evaluate as jev
from tpufcn.train import validate as jval
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DataConfig, DetectorConfig, GridConfig
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.data.device_compositor import CropLibrary, \
    DeviceCompositePipeline
from torchfcn.models import build
from torchfcn.serve.detector import Detector
from torchfcn.train import evaluate as tev
from torchfcn.train import validate as tval

torch.set_num_threads(2)

HW, CLASSES = 64, 3
SEG_ATOL = 2e-3


def _gt_dets(rng, n_img=12, classes=4):
    gts, dets = [], []
    for _ in range(n_img):
        m = int(rng.integers(0, 4))
        xy = rng.uniform(0, 80, (m, 2))
        gts.append((np.concatenate([xy, xy + rng.uniform(5, 40, (m, 2))], 1),
                    rng.integers(0, classes, m)))
        # a jittered copy of the GT (some with another label) and false
        # positives, with tied scores
        k = int(rng.integers(0, 4))
        xy = rng.uniform(0, 80, (k, 2))
        boxes = np.concatenate([
            gts[-1][0] + rng.normal(0, 3, (m, 4)),
            np.concatenate([xy, xy + rng.uniform(5, 40, (k, 2))], 1)])
        labels = np.concatenate([
            np.where(rng.random(m) < 0.8, gts[-1][1], 0),
            rng.integers(0, classes, k)])
        dets.append((boxes, labels, rng.integers(0, 5, m + k) / 4.0))
    return gts, dets


@pytest.mark.parametrize("use_07", [False, True])
def test_evaluate_detections_equals_jax(use_07):
    gts, dets = _gt_dets(np.random.default_rng(0))
    for thresh in (0.3, 0.5):
        got = tev.evaluate_detections(gts, dets, 4, thresh, use_07)
        want = jev.evaluate_detections(gts, dets, 4, thresh, use_07)
        assert got == want
        assert 0 < got["mAP"] < 1


def test_evaluate_segmentation_equals_jax():
    rng = np.random.default_rng(1)
    gt = [rng.integers(0, 5, (16, 16)) for _ in range(3)]
    pred = [np.where(rng.random((16, 16)) < 0.6, g, rng.integers(0, 5))
            for g in gt]
    for ignore in (None, 4):
        got = tev.evaluate_segmentation(gt, pred, 5, ignore)
        want = jev.evaluate_segmentation(gt, pred, 5, ignore)
        assert np.array_equal(got.pop("confusion"), want.pop("confusion"))
        assert got == want


@pytest.fixture(scope="module")
def held_out():
    """10 scenes of 3 classes composed by the port at 64x64."""
    rng = np.random.default_rng(2)
    imgs, masks, labels = [], [], []
    for i in range(6):
        h, w = int(rng.integers(12, 21)), int(rng.integers(12, 21))
        imgs.append(np.full((h, w, 3), (60 + 70 * (i % 3), 200, 90),
                            np.uint8))
        masks.append(np.ones((h, w), np.uint8))
        labels.append(i % CLASSES)
    pipe = DeviceCompositePipeline(
        CropLibrary.from_arrays(imgs, masks, labels),
        rng.uniform(0, 80, (2, HW, HW, 3)), GridConfig(HW, HW, 8, CLASSES),
        DataConfig(compose_max_trials=16), seed=99, device="cpu")
    images, gts, seg = tval.val_set_from_compositor(pipe, 10, batch=4)
    assert images.shape == (10, HW, HW, 3) and seg.shape == (10, HW, HW)
    assert sum(len(g[1]) for g in gts) >= 10
    return images.numpy(), gts, seg


def test_score_detection_matches_jax(held_out):
    images, gts, _ = held_out
    name = "vgg_detectnet_train"
    grid = GridConfig(HW, HW, 8, CLASSES)
    jdet = jax_det.Detector(
        name, dtype=jnp.float32, model_kwargs={"num_classes": CLASSES},
        config=JDetectorConfig(grid=JGridConfig(HW, HW, 8, CLASSES),
                               model=name, max_candidates=64))
    params = jax.tree.map(np.array, jdet.params)
    params["params"]["cvg/classifier"]["conv"]["bias"][:] = 1.0
    params["params"]["bbox/regressor"]["conv"]["bias"][:] = \
        [-24, -24, 40, 40] * CLASSES
    jdet.params = jax.tree.map(jnp.asarray, params)
    config = DetectorConfig(grid=grid, model=name, max_candidates=64)
    det = Detector(name, dtype=torch.float32, config=config,
                   model_kwargs={"num_classes": CLASSES}, device="cpu")
    load_jax_params(det.model, params)
    assert det.num_fg == jdet.num_fg == CLASSES
    # the heads find one large box a class: every other image's GT becomes
    # the boxes tpufcn finds there, shifted, so that the mAP is not 0
    found = jdet(images).to_lists()
    gts = [g if i % 2 else
           (np.asarray([b for b, _, _ in found[i]], np.float64) + 2,
            np.asarray([l for _, l, _ in found[i]], np.int64))
           for i, g in enumerate(gts)]
    want = jval.score_detection(jdet, images, gts, CLASSES, chunk=4)
    got = tval.score_detection(det, images, gts, CLASSES, chunk=4)
    assert got == want
    assert got[1] > 0 and 0 < got[0] < 1
    validate = tval.detection_validator(
        name, torch.from_numpy(images), gts,
        model_kwargs={"num_classes": CLASSES}, chunk=4, config=config)
    assert validate(det.model) == {"mAP": round(want[0], 4),
                                   "n_det": want[1]}


def test_seg_validator_matches_jax(held_out, monkeypatch):
    images, _, masks = held_out
    images, masks = images[:3], masks[:3]
    name = "fcn32s_seg"
    spec = tpufcn.models.get_spec(name)
    small = dataclasses.replace(spec, grid=dataclasses.replace(
        spec.grid, im_width=HW, im_height=HW))
    monkeypatch.setattr(tpufcn.models, "get_spec",
                        lambda n: small if n == name else spec)
    jmodel = tpufcn.models.build(name, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3), jnp.float32)))
    want = jval.seg_validator(name, images, masks,
                              model_kwargs={"dtype": jnp.float32},
                              chunk=2)(params)
    model = build(name)
    DTypePolicy.parity().apply(model)
    load_jax_params(model, params)
    model.eval()
    got = tval.seg_validator(name, torch.from_numpy(images), masks,
                             chunk=2)(model)
    assert set(got) == {"mIoU", "pixel_accuracy"}
    for k in got:
        assert abs(got[k] - want[k]) <= SEG_ATOL, (k, got, want)


def test_manifest_sets_use_the_callers_decoder(tmp_path):
    import cv2 as cv
    rng = np.random.default_rng(3)
    store = {f"i{i}": rng.integers(0, 256, (48, 80, 3)).astype(np.uint8)
             for i in range(2)}
    store.update({f"m{i}": np.where(rng.random((48, 80, 3)) < 0.5, 255,
                                    0).astype(np.uint8) for i in range(2)})
    det_manifest = tmp_path / "det.txt"
    det_manifest.write_text("i0 4 6 20 10 1\ni1 0 0 30 30 2\n")
    with pytest.raises(ValueError, match="decoder"):
        tval.val_set_from_manifest(str(det_manifest), (32, 32))
    images, gts = tval.val_set_from_manifest(
        str(det_manifest), (32, 32), imread=store.get, resize=cv.resize)
    assert images.shape == (2, 32, 32, 3)
    assert np.array_equal(images[0], cv.resize(store["i0"], (32, 32)))
    np.testing.assert_allclose(gts[0][0], [[1.6, 4.0, 9.6, 10.6667]],
                               atol=1e-4)
    assert gts[1][1].tolist() == [1]
    seg_manifest = tmp_path / "seg.txt"
    seg_manifest.write_text("i0 m0 7 0 0 4 4\n\ni1 m1 9 0 0 4 4\n")
    images, masks = tval.seg_val_set_from_manifest(
        str(seg_manifest), (32, 32), imread=store.get, resize=cv.resize)
    for i, label in enumerate((1, 2)):
        gray = cv.cvtColor(store[f"m{i}"], cv.COLOR_BGR2GRAY)
        want = cv.resize(gray, (32, 32), interpolation=cv.INTER_NEAREST)
        assert np.array_equal(masks[i], np.where(want > 0, label, 0))
