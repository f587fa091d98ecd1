"""``Detector.forward_fn``, ``torchfcn.entry.entry`` and the serving
artifacts of ``torchfcn/serve/export.py`` on the CPU.

* ``forward_fn``'s ``fn(params, frames)`` against tpufcn's
  ``forward_fn`` on the same weights (vgg_detectnet_train at 64x64,
  float32, the heads biased as in ``tests/test_torch_family_detector.py``):
  (box, label) lists equal, confidences within 1 ulp (XLA's CPU float32
  log); and against the port's own Detector: equal.
* ``entry(device="cpu")``: the flagship Detector (googlenet_detectnet,
  bf16, K = 256) as a function and its arguments: a zero (8, 448, 448, 3)
  uint8 batch and the Detector's parameters; ``fn`` equals that Detector
  on seeded frames.
* ``export_detector`` / ``load_exported``: a round trip equals the
  Detector exactly (GoogLeNet DetectNet with one class at B = 2, float32,
  and the e5m2 serving preset at B = 1); the saved graph calls the custom
  ops ``torchfcn.group_rects``, ``torchfcn.lrn`` and
  ``torchfcn.lrn_maxpool`` (``torchfcn.stem_tail`` for the preset); the
  weights stay outside the artifact (it is far smaller than they are,
  and other parameters give the Detector's result for them with no new
  export).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufcn.core.config import DetectorConfig as JDetectorConfig
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.serve import detector as jax_det
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DetectorConfig, GridConfig
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.serve.detector import Detector
from torchfcn.serve.export import export_detector, load_exported
from torchfcn.serve.profile import bias_heads

torch.set_num_threads(2)

BOX = np.float32([-24, -24, 120, 120])


def _meta(art):
    """What the artifact records beside the program."""
    extra = {"torchfcn_export.json": ""}
    torch.export.load(io.BytesIO(art), extra_files=extra)
    return json.loads(extra["torchfcn_export.json"])


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _frames(n, hw, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,),
                                                dtype=np.uint8)


def test_forward_fn_matches_jax_and_the_detector():
    name, hw, classes = "vgg_detectnet_train", 64, 11
    jdet = jax_det.Detector(name, dtype=jnp.float32, config=JDetectorConfig(
        grid=JGridConfig(hw, hw, stride=8, num_classes=classes), model=name))
    params = jax.tree.map(np.array, jdet.params)
    params["params"]["cvg/classifier"]["conv"]["bias"][:] = 1.0
    params["params"]["bbox/regressor"]["conv"]["bias"][:] = np.tile(
        BOX, classes)
    det = Detector(name, device="cpu", policy=DTypePolicy.parity(),
                   config=DetectorConfig(grid=GridConfig(hw, hw, stride=8,
                                                         num_classes=classes),
                                         model=name))
    load_jax_params(det.model, params)
    frames = _frames(3, (hw, hw))

    jfn, _ = jdet.forward_fn()
    want = jfn(jax.tree.map(jnp.asarray, params), jnp.asarray(frames))
    fn, tparams = det.forward_fn()
    got = fn(tparams, torch.from_numpy(frames))
    assert _equal(got, det(frames))
    lists, jlists = got.to_lists(), jax_det.DetectionResult(
        *want).to_lists()
    assert sum(map(len, lists)) > 0
    for g, w in zip(lists, jlists):
        g, w = sorted(g), sorted(w)
        assert [d[:2] for d in g] == [d[:2] for d in w]
        np.testing.assert_array_max_ulp(np.float32([d[2] for d in g]),
                                        np.float32([d[2] for d in w]), 1)
    # the parameters are an input: every parameter and buffer of the model
    assert set(tparams) == set(det.model.state_dict())
    assert not got.boxes.requires_grad


def test_entry_is_the_flagship_detector_as_a_function():
    from torchfcn.entry import entry
    fn, (params, frames) = entry(device="cpu")
    assert frames.shape == (8, 448, 448, 3) and frames.dtype == torch.uint8
    assert not frames.any()
    det = Detector("googlenet_detectnet", dtype=torch.bfloat16,
                   max_candidates=256, device="cpu")
    for k, v in det.model.state_dict().items():
        assert torch.equal(params[k], v)
    bias_heads(det)              # so that NMS sees clusters
    biased = dict(params, **{k: v for k, v in det.model.state_dict().items()
                             if k.startswith(("cvg.", "bbox."))})
    x = _frames(1, (448, 448), seed=1)
    got = fn(biased, torch.from_numpy(x))
    assert got.boxes.shape == (1, 4, 256, 4) and got.valid.any()
    assert _equal(got, det(x))


@pytest.fixture(scope="module")
def flagship_1cls():
    det = Detector("googlenet_detectnet_1cls", dtype=torch.float32,
                   max_candidates=32, device="cpu")
    bias_heads(det)
    return det


def test_export_round_trip_equals_the_detector(flagship_1cls):
    det = flagship_1cls
    frames = torch.from_numpy(_frames(2, (448, 448)))
    art = export_detector(det, 2)
    meta = _meta(art)
    assert meta == {"model": "googlenet_detectnet_1cls", "batch": 2,
                    "in_hw": [448, 448], "exact": True, "device": "cpu"}
    fn = load_exported(art)
    _, params = det.forward_fn()
    want = det(frames)
    assert want.valid.any()
    assert _equal(fn(params, frames), want)

    ops = {str(n.target) for n in torch.export.load(
        io.BytesIO(art)).graph.nodes if "torchfcn" in str(n.target)}
    assert {"torchfcn.group_rects.default", "torchfcn.lrn.default",
            "torchfcn.lrn_maxpool.default"} <= ops

    # the weights are an input, not a part of the artifact
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    assert len(art) < weight_bytes / 10
    other = {k: v * 1.25 if v.is_floating_point() else v
             for k, v in params.items()}
    det2 = Detector("googlenet_detectnet_1cls", dtype=torch.float32,
                    max_candidates=32, device="cpu")
    det2.model.load_state_dict(other)
    want2 = det2(frames)
    assert not _equal(want2, want)
    assert _equal(fn(other, frames), want2)


def test_export_at_the_camera_size(flagship_1cls):
    """in_hw bakes the resize to the net's size into the program."""
    det = flagship_1cls
    frames = torch.from_numpy(_frames(1, (240, 320), seed=2))
    fn = load_exported(export_detector(det, 1, in_hw=(240, 320)))
    assert _equal(fn(det.forward_fn()[1], frames), det(frames))


def test_export_of_the_serving_preset_calls_the_stem_tail():
    det = Detector("googlenet_detectnet_serving", max_candidates=32,
                   device="cpu")
    bias_heads(det)
    art = export_detector(det, 1)
    ops = {str(n.target) for n in torch.export.load(
        io.BytesIO(art)).graph.nodes if "torchfcn" in str(n.target)}
    assert {"torchfcn.stem_tail.default",
            "torchfcn.group_rects.default"} <= ops
    assert "torchfcn.lrn.default" not in ops
    frames = torch.from_numpy(_frames(1, (448, 448), seed=3))
    assert not _meta(art)["exact"]
    assert _equal(load_exported(art)(det.forward_fn()[1], frames),
                  det(frames))
