"""torchfcn's serving path against tpufcn's: grid decode, top-K candidate
selection, decode + NMS on shared head outputs, and the whole slice
(frames -> DetectionResult) on the same weights.

Boxes and validity must match exactly.  Confidence is log(votes): the port
rounds it once from float64, so it is exact; XLA's CPU float32 log is off
by 1 ulp for 16 of the vote counts 1..1024 (7 among them), so against JAX
it is held to 1 ulp."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import DetectorConfig as JaxDetectorConfig
from tpufcn.core.config import GridConfig as JaxGridConfig
from tpufcn.ops.grid_codec import decode_gridboxes as jax_decode
from tpufcn.serve import detector as jax_det
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DetectorConfig, GridConfig
from torchfcn.ops.grid_codec import decode_gridboxes
from torchfcn.ops.image import resize_bilinear
from torchfcn.serve.detector import Detector, select_candidates

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_decode_gridboxes_matches_jax(rng):
    grid = GridConfig(128, 96, stride=16, num_classes=3)
    jgrid = JaxGridConfig(128, 96, stride=16, num_classes=3)
    cov = rng.random((2, 6, 8, 3)).astype(np.float32)
    cov[0, 0, 0] = 0.5                                   # threshold edge
    bbox = rng.normal(0, 30, (2, 6, 8, 12)).astype(np.float32)
    got = decode_gridboxes(torch.from_numpy(cov), torch.from_numpy(bbox),
                           grid, 0.5)
    want = jax.vmap(lambda c, b: jax_decode(c, b, jgrid, 0.5))(cov, bbox)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_select_candidates_matches_jax(rng):
    """Ties, negative coords and out-of-range clamping
    (tests/test_detector_parity.py cases)."""
    B, C, M, K = 3, 2, 96, 32
    cvg = rng.random((B, C, M)).astype(np.float32)
    cvg[rng.random((B, C, M)) < 0.3] = 0.5  # ties
    boxes = rng.uniform(-600, 900, (B, C, M, 4)).astype(np.float32)
    boxes[0, 0, 0] = [-5000.0, 5000.0, 3.4, -2048.4]  # clamp surface
    valid = rng.random((B, C, M)) < 0.6
    got_boxes, got_valid = select_candidates(
        torch.from_numpy(cvg), torch.from_numpy(boxes),
        torch.from_numpy(valid), K)
    want_boxes, want_valid = jax.jit(
        jax_det.select_candidates, static_argnums=3)(cvg, boxes, valid, K)
    assert np.array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert np.array_equal(got_boxes.numpy(), np.asarray(want_boxes))


def _assert_results_match(got, want):
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert np.array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    assert got.boxes.dtype == torch.int32
    np.testing.assert_array_max_ulp(got.confidence.numpy(),
                                    np.asarray(want.confidence), maxulp=1)
    # ...and exactly log(votes) rounded once
    conf = got.confidence[got.valid].double()
    votes = torch.round(torch.exp(conf))
    assert torch.equal(got.confidence[got.valid],
                       torch.log(votes).float())


def _clustered_heads(rng, b, c):
    """28x28 heads whose cells fire in tied coverage steps, with corner
    offsets that cluster into tall boxes."""
    cov = rng.integers(0, 8, (b, 28, 28, c)).astype(np.float32) / 8
    bbox = (np.tile(np.array([-24, -24, 40, 40], np.float32), c)
            + rng.normal(0, 3, (b, 28, 28, 4 * c))).astype(np.float32)
    return cov, bbox


@pytest.mark.parametrize("max_candidates", [256, None])
def test_decode_nms_matches_jax_on_shared_heads(rng, max_candidates):
    cov, bbox = _clustered_heads(rng, 2, 4)
    in_hw = (896, 672)            # exercises the truncating rescale
    det = Detector("googlenet_detectnet", max_candidates=max_candidates,
                   dtype=torch.float32, device="cpu")
    got = det._decode_nms(torch.from_numpy(cov), torch.from_numpy(bbox),
                          in_hw)
    jdet = jax_det.Detector("googlenet_detectnet", dtype=jnp.float32,
                            max_candidates=max_candidates, params={})
    want = jax.jit(jdet._decode_nms, static_argnums=2)(cov, bbox, in_hw)
    assert int(got.valid.sum()) > 0
    _assert_results_match(got, want)


def test_whole_slice_matches_jax(rng):
    """googlenet_detectnet_1cls at 128x128, f32, heads biased so cells
    fire with tall boxes: per (image, class) the (box, conf) sets match."""
    jgrid = JaxGridConfig(128, 128, stride=16, num_classes=1)
    jdet = jax_det.Detector(
        "googlenet_detectnet_1cls", dtype=jnp.float32,
        config=JaxDetectorConfig(grid=jgrid, model="googlenet_detectnet_1cls"),
        params=None, rng_seed=0)
    params = jax.tree.map(np.array, jdet.params)
    params["params"]["cvg/classifier"]["conv"]["bias"][:] = 1.0
    params["params"]["bbox/regressor"]["conv"]["bias"][:] = [-48, -48, 80, 80]
    jdet.params = jax.tree.map(jnp.asarray, params)

    grid = GridConfig(128, 128, stride=16, num_classes=1)
    det = Detector("googlenet_detectnet_1cls", dtype=torch.float32,
                   config=DetectorConfig(grid=grid,
                                         model="googlenet_detectnet_1cls"),
                   device="cpu")
    load_jax_params(det.model, params)

    frames = rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    got, want = det(frames), jdet(frames)
    got_lists, want_lists = got.to_lists(), want.to_lists()
    assert sum(map(len, got_lists)) > 0
    for g_img, w_img in zip(got_lists, want_lists):
        g_img, w_img = sorted(g_img), sorted(w_img)
        assert [d[:2] for d in g_img] == [d[:2] for d in w_img]
        np.testing.assert_array_max_ulp(
            np.float32([d[2] for d in g_img]),
            np.float32([d[2] for d in w_img]), maxulp=1)


def test_detector_devices_and_frame_size(monkeypatch, rng):
    """Frames of another size than the net's are resized, and their boxes
    come back in the frames' coordinates: those of the same frames resized
    to 448x448 by hand, scaled by 224/448 and truncated."""
    det = Detector("googlenet_detectnet_1cls", dtype=torch.float32,
                   device="cpu")
    with torch.no_grad():
        det.model.cvg.bias.fill_(1.0)
        det.model.bbox.bias.copy_(torch.tensor([-48.0, -48.0, 80.0, 80.0]))
    frames = rng.integers(0, 256, (1, 224, 224, 3)).astype(np.uint8)
    got = det(frames)
    at_net = det(resize_bilinear(torch.from_numpy(frames), (448, 448)))
    assert int(got.valid.sum()) > 0
    assert torch.equal(got.valid, at_net.valid)
    assert torch.equal(got.boxes, (at_net.boxes.float() * 0.5).int())
    with pytest.raises(ValueError, match="cuda"):
        Detector("googlenet_detectnet_1cls", device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector("googlenet_detectnet_1cls")


def test_port_imports_without_jax():
    """The port never imports JAX, Flax or tpufcn: statically, and when
    they cannot be imported at all."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|tpufcn)\b", re.M)
    offenders = [str(p) for p in (REPO / "torchfcn").rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += [p for p in ("chip_smoke.py",)
                  if pattern.search((REPO / p).read_text())]
    assert not offenders
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'tpufcn'): sys.modules[m] = None\n"
            "import torchfcn.serve.detector, torchfcn.convert.from_jax\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
