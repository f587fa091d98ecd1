"""GoogLeNet DetectNet with e5m2 storage and ``store_stem2`` off (the JAX
model's default: conv1, pool1 and LRN1 stored e5m2; conv2_reduce, conv2
and LRN2 + pool2 in bf16) against tpufcn's on the same weights, on the CPU.

``googlenet_detectnet`` with ``store_dtype`` e5m2 at 128x128, B = 2: LRN1's
stored output counted in e5m2 steps (a bf16 ulp can flip an e5m2 rounding;
measured: every value equal), and the heads held to a share of bit-equal
entries and a largest |difference|, twice the measured ones:

  head      bit-equal        max |diff|
  coverage  >= 20 % (26.0)   2.9e-3 (1.44e-3 of 0.61)
  bboxes    >= 20 % (26.7)   1.6e-2 (7.8e-3 of 0.93)

(XLA on the CPU skips some bf16 roundings and sums in other orders, so the
bf16 convs after LRN1 round apart now and then.)  The serving preset with
``store_stem2=False`` also stores the inception blocks, so a flipped e5m2
value spreads through nine blocks: its heads are held, as
tests/test_torch_family_serving.py holds ResNet-FPN's, to lie no further
from tpufcn's on average than e5m2 storage moves the port's own heads.
Decode + NMS of the same heads equals tpufcn's, and the Detector runs the
``lrn`` kernel on LRN1's e5m2 values widened to bf16 and ``lrn_maxpool``
on bf16, never the stem tail.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import DetectorConfig as JDetectorConfig
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.models import build as jax_build
from tpufcn.serve import detector as jax_det
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DetectorConfig, GridConfig
from torchfcn.models import build, googlenet, layers
from torchfcn.models.layers import nhwc
from torchfcn.serve.detector import Detector

from test_torch_detector import _assert_results_match
from test_torch_stem import e5m2_steps

torch.set_num_threads(2)

HW, BATCH = 128, 2
E5M2 = torch.float8_e5m2
# head: (least bit-equal share, max |diff|)
BOUNDS = {"coverage": (0.20, 2.9e-3), "bboxes": (0.20, 1.6e-2)}


def _reference(name, **kwargs):
    """tpufcn's params (numpy), frames, heads and LRN1's stored output."""
    model = jax_build(name, dtype=jnp.bfloat16, **kwargs)
    params = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3), jnp.float32)))
    frames = np.random.default_rng(1).integers(
        0, 256, (BATCH, HW, HW, 3)).astype(np.uint8)
    out, inter = jax.jit(lambda p, x: model.apply(
        p, x, capture_intermediates=True))(params,
                                           jnp.asarray(frames, jnp.float32))
    lrn1 = np.asarray(inter["intermediates"]["pool1/norm1"]["__call__"][0])
    return params, frames, {k: np.asarray(v, np.float32)
                            for k, v in out.items()}, lrn1


def _port(name, params, frames, **kwargs):
    """The port's heads and LRN1's output stored in e5m2 (NHWC)."""
    model = build(name, **kwargs).to(dtype=torch.bfloat16,
                                     memory_format=torch.channels_last)
    load_jax_params(model, params)
    lrn1 = []
    model.norm1.register_forward_hook(
        lambda module, args, out: lrn1.append(out))
    with torch.no_grad():
        heads = {k: v.numpy() for k, v in
                 model(torch.from_numpy(frames)).items()}
    return heads, nhwc(lrn1[0]).to(E5M2)


@pytest.fixture(scope="module")
def reference():
    return _reference("googlenet_detectnet", store_dtype=jnp.float8_e5m2)


def test_store_stem2_off_matches_jax(reference):
    params, frames, want, lrn1 = reference
    got, port_lrn1 = _port("googlenet_detectnet", params, frames,
                           store_dtype=E5M2)
    assert lrn1.dtype == jnp.float8_e5m2 and port_lrn1.shape == lrn1.shape
    steps = e5m2_steps(port_lrn1.view(torch.uint8).numpy(), lrn1)
    print(f"LRN1: {100 * (steps == 0).mean():.3f} % equal, at most "
          f"{steps.max()} e5m2 steps apart")
    assert (steps == 0).mean() >= 0.999 and steps.max() <= 1
    for key, (share, atol) in BOUNDS.items():
        g = got[key]
        assert g.dtype == np.float32 and g.shape == want[key].shape, key
        print(f"{key}: {100 * (g == want[key]).mean():.1f} % bit-equal, "
              f"max |diff| {np.abs(g - want[key]).max():.3g}")
        assert (g == want[key]).mean() >= share, key
        np.testing.assert_allclose(g, want[key], rtol=0, atol=atol,
                                   err_msg=key)


def test_store_stem2_off_nearer_jax_than_storage(reference):
    """e5m2 storage moves the port's heads (against its exact bf16 model)
    further than the two frameworks differ on the e5m2 model."""
    params, frames, want, _ = reference
    got, _ = _port("googlenet_detectnet", params, frames, store_dtype=E5M2)
    exact, _ = _port("googlenet_detectnet", params, frames)
    for key in ("coverage", "bboxes"):
        to_jax = np.abs(got[key] - want[key]).mean()
        storage = np.abs(got[key] - exact[key]).mean()
        print(f"{key}: mean |port - tpufcn| {to_jax:.3g}, e5m2 storage "
              f"{storage:.3g}")
        assert 0 < to_jax <= 0.5 * storage, key


def test_serving_preset_with_store_stem2_off_matches_jax():
    """tpufcn's serving factory takes ``store_stem2=False``
    (``tpufcn/models/registry.py``); so does the port's."""
    params, frames, want, lrn1 = _reference("googlenet_detectnet_serving",
                                            store_stem2=False)
    got, port_lrn1 = _port("googlenet_detectnet_serving", params, frames,
                           store_stem2=False)
    exact, _ = _port("googlenet_detectnet", params, frames)
    steps = e5m2_steps(port_lrn1.view(torch.uint8).numpy(), lrn1)
    assert (steps == 0).mean() >= 0.999 and steps.max() <= 1
    for key in ("coverage", "bboxes"):
        assert np.isfinite(got[key]).all()
        to_jax = np.abs(got[key] - want[key]).mean()
        storage = np.abs(got[key] - exact[key]).mean()
        print(f"{key}: mean |port - tpufcn| {to_jax:.3g}, e5m2 storage "
              f"{storage:.3g}")
        assert 0 < to_jax <= 1.1 * storage, key


def _biased(params):
    """tpufcn's params with the heads biased so that cells fire with tall
    boxes (tests/test_torch_detector.py::test_whole_slice_matches_jax)."""
    params = jax.tree.map(np.array, params)
    params["params"]["cvg/classifier"]["conv"]["bias"][:] = 1.0
    params["params"]["bbox/regressor"]["conv"]["bias"][:] = np.tile(
        [-48, -48, 80, 80], 4)
    return params


def test_detections_equal_jax_for_the_same_heads(reference):
    """The port's Detector of this configuration: decode + NMS of its
    heads equals tpufcn's decode + NMS of the same heads."""
    params, frames, _, _ = reference
    grid = GridConfig(HW, HW, stride=16, num_classes=4)
    det = Detector("googlenet_detectnet", dtype=torch.bfloat16,
                   config=DetectorConfig(grid=grid,
                                         model="googlenet_detectnet"),
                   device="cpu", model_kwargs={"store_dtype": E5M2})
    assert det.model.store_dtype == E5M2 and not det.model.store_stem2
    load_jax_params(det.model, _biased(params))
    got = det(frames)
    with torch.inference_mode():
        cov, bbox = det._forward(torch.from_numpy(frames))
    jdet = jax_det.Detector(
        "googlenet_detectnet", dtype=jnp.float32,
        config=JDetectorConfig(grid=JGridConfig(HW, HW, stride=16,
                                                num_classes=4),
                               model="googlenet_detectnet"), params={})
    want = jax.jit(jdet._decode_nms, static_argnums=2)(
        cov.float().numpy(), bbox.float().numpy(), (HW, HW))
    assert int(got.valid.sum()) > 0
    _assert_results_match(got, want)


def test_detector_runs_the_lrn_kernels_not_the_stem_tail(rng, monkeypatch):
    """On the CPU each wrapper runs its plain version; the Detector calls
    ``lrn`` once on LRN1's e5m2 values widened to bf16, ``lrn_maxpool``
    once on bf16, and the stem tail never."""
    calls = []
    for name in ("lrn_cuda", "lrn_maxpool_cuda"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda x, *a, _r=real, _n=name, **k:
                            (calls.append((_n, x)), _r(x, *a, **k))[1])
    monkeypatch.setattr(googlenet, "stem_tail_cuda", lambda *a: (
        calls.append(("stem_tail_cuda", None)), None)[1])
    det = Detector("googlenet_detectnet", max_candidates=32, device="cpu",
                   config=DetectorConfig(
                       grid=GridConfig(HW, HW, stride=16, num_classes=4),
                       model="googlenet_detectnet", max_candidates=32),
                   model_kwargs={"store_dtype": E5M2})
    with torch.no_grad():
        det.model.cvg.bias.fill_(1.0)
        det.model.bbox.bias.copy_(torch.tensor(
            [-48.0, -48.0, 80.0, 80.0]).repeat(4))
    frames = rng.integers(0, 256, (BATCH, HW, HW, 3)).astype(np.uint8)
    got = det(frames)
    assert [n for n, _ in calls] == ["lrn_cuda", "lrn_maxpool_cuda"]
    x = calls[0][1]
    assert x.dtype == torch.bfloat16
    assert torch.equal(x, x.to(E5M2).to(torch.bfloat16))
    assert calls[1][1].dtype == torch.bfloat16
    with torch.inference_mode():
        want = det._decode_nms(*det._forward(torch.from_numpy(frames)),
                               (HW, HW))
    assert int(got.valid.sum()) > 0
    for field in ("boxes", "confidence", "valid"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
