"""torchfcn's fp8 serving preset ``googlenet_detectnet_serving`` (e5m2
storage, bf16 compute, the stem tail in one kernel) against tpufcn's on the
same weights, against the port's exact model, and through the Detector.

Against JAX at 128x128, B = 2: at least 99 % of the head entries equal, the
rest within atol 2e-3 (coverage) and 2e-2 (bboxes, which reach about 1.0
here).  Measured: bboxes all equal, coverage max |diff| 3.0e-08; the e5m2
roundings absorb the two frameworks' different bf16 rounding of conv plus
bias.  The JAX model is initialised and applied once per module."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.models import build as jax_build
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DetectorConfig, GridConfig
from torchfcn.models import build, googlenet
from torchfcn.serve.detector import Detector

torch.set_num_threads(2)

HW, BATCH = 128, 2


@pytest.fixture(scope="module")
def reference():
    """JAX serving params (numpy tree), frames and bf16 outputs at 128x128."""
    model = jax_build("googlenet_detectnet_serving", dtype=jnp.bfloat16)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    frames = np.random.default_rng(1).integers(
        0, 256, (BATCH, HW, HW, 3)).astype(np.uint8)
    out = jax.jit(model.apply)(params, jnp.asarray(frames, jnp.float32))
    return params, frames, {k: np.asarray(v, np.float32)
                            for k, v in out.items()}


def _port_heads(name, params, frames):
    model = build(name).to(dtype=torch.bfloat16,
                           memory_format=torch.channels_last)
    load_jax_params(model, params)
    with torch.no_grad():
        return {k: v.numpy() for k, v in model(torch.from_numpy(frames))
                .items()}


def test_serving_matches_jax(reference):
    params, frames, want = reference
    got = _port_heads("googlenet_detectnet_serving", params, frames)
    for key, atol in (("coverage", 2e-3), ("bboxes", 2e-2)):
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == np.float32
        assert (got[key] == want[key]).mean() >= 0.99, key
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0,
                                   err_msg=key)


def test_serving_agrees_with_exact(reference):
    """e5m2 storage perturbs the heads but does not derail them: coverage
    (probabilities) within a mean |diff| of 0.02, as tests/test_models.py
    holds the JAX fp8 presets; bboxes within a mean of a quarter of their
    mean magnitude, one e5m2 step at most (measured 0.044 against 0.258,
    17 %: e5m2 keeps 2 mantissa bits)."""
    params, frames, _ = reference
    fast = _port_heads("googlenet_detectnet_serving", params, frames)
    exact = _port_heads("googlenet_detectnet", params, frames)
    assert np.abs(fast["coverage"] - exact["coverage"]).mean() < 0.02
    diff = np.abs(fast["bboxes"] - exact["bboxes"]).mean()
    assert diff < 0.25 * np.abs(exact["bboxes"]).mean()
    assert all(np.isfinite(v).all() for v in fast.values())


def test_weight_bridge_loads_serving_tree(reference):
    """The JAX serving tree loads strictly into the serving model, whose
    parameters are those of the exact model."""
    params, _, _ = reference
    model = build("googlenet_detectnet_serving")
    load_jax_params(model, params)
    exact = build("googlenet_detectnet")
    assert [(n, p.shape) for n, p in model.named_parameters()] == \
        [(n, p.shape) for n, p in exact.named_parameters()]
    load_jax_params(exact, params)
    for (name, a), b in zip(model.named_parameters(), exact.parameters()):
        assert torch.equal(a, b), name
    assert model.conv2.weight.abs().sum() > 0


def test_serving_detector_end_to_end_on_cpu(rng, monkeypatch):
    """Detector("googlenet_detectnet_serving") on the CPU: the stem tail
    runs once per batch on the e5m2 pool1 output, and the result equals
    decode + NMS of its own heads."""
    calls = []
    stem = googlenet.stem_tail_cuda
    monkeypatch.setattr(googlenet, "stem_tail_cuda", lambda x, *a: (
        calls.append(x.dtype), stem(x, *a))[1])
    grid = GridConfig(HW, HW, stride=16, num_classes=4)
    det = Detector("googlenet_detectnet_serving", max_candidates=32,
                   config=DetectorConfig(
                       grid=grid, model="googlenet_detectnet_serving",
                       max_candidates=32),
                   device="cpu")
    with torch.no_grad():
        det.model.cvg.bias.fill_(1.0)
        det.model.bbox.bias.copy_(torch.tensor(
            [-48.0, -48.0, 80.0, 80.0]).repeat(4))
    frames = rng.integers(0, 256, (BATCH, HW, HW, 3)).astype(np.uint8)
    got = det(frames)
    assert calls == [torch.float8_e5m2]
    with torch.inference_mode():
        want = det._decode_nms(*det._forward(torch.from_numpy(frames)),
                               (HW, HW))
    assert int(got.valid.sum()) > 0
    for field in ("boxes", "confidence", "valid"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_serving_flags():
    with pytest.raises(ValueError, match="bfloat16"):
        build("googlenet_detectnet_serving")(
            torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
    # e5m2 storage without store_stem2 (the JAX model's default) builds:
    # conv1, pool1 and LRN1 stored e5m2 (tests/test_torch_stem2.py)
    model = googlenet.GoogLeNetDetectNet(store_dtype=torch.float8_e5m2)
    assert model.store_dtype == torch.float8_e5m2 and not model.store_stem2
    heads = model.eval().to(torch.bfloat16)(
        torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
    assert heads["bboxes"].shape == (1, 4, 4, 16)
    with pytest.raises(ValueError, match="e4m3"):
        googlenet.GoogLeNetDetectNet(store_dtype=torch.float8_e4m3fn,
                                     store_stem2=True)
