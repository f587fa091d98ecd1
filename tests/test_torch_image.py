"""torchfcn's frame resize (``torchfcn/ops/image.py``) against tpufcn's
``resize_bilinear`` (``jax.image.resize``, antialiased linear), and the
whole slice on frames that are not the net's size.

Resize tolerance: atol 1e-3 on the 0..255 scale; both sides sum a few
float32 products, in other orders."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import DetectorConfig as JaxDetectorConfig
from tpufcn.core.config import GridConfig as JaxGridConfig
from tpufcn.ops.image import resize_bilinear as jax_resize
from tpufcn.serve import detector as jax_det
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DetectorConfig, GridConfig
from torchfcn.ops.image import resize_bilinear
from torchfcn.serve.detector import Detector

torch.set_num_threads(2)

# (B, H, W, C) in, (h, w) out
CASES = {
    "downscale_non_integer": ((2, 100, 90, 3), (64, 48)),
    "downscale_2x": ((1, 64, 96, 3), (32, 48)),
    "upscale": ((1, 20, 30, 3), (48, 64)),
    "mixed_axes": ((2, 160, 120, 3), (128, 128)),
    "camera_frame": ((1, 480, 640, 3), (448, 448)),
    "identity": ((1, 33, 47, 3), (33, 47)),
}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_resize_matches_jax(rng, case, dtype):
    shape, size = CASES[case]
    if dtype == "uint8":
        img = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        img = rng.uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(img), size))
    got = resize_bilinear(torch.from_numpy(img), size)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    if case == "identity":
        assert np.array_equal(got.numpy(), img.astype(np.float32))


def test_whole_slice_on_other_frame_sizes_matches_jax(rng):
    """googlenet_detectnet_1cls at a 128x128 grid, f32, heads biased so
    cells fire with tall boxes, on 160x120 frames: both Detectors resize
    them, and per (image, class) the (box, conf) sets match in frame
    coordinates; boxes and validity exact, confidence within 1 ulp."""
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

    frames = rng.integers(0, 256, (2, 120, 160, 3)).astype(np.uint8)
    got, want = det(frames), jdet(frames)
    got_lists, want_lists = got.to_lists(), want.to_lists()
    assert sum(map(len, got_lists)) > 0
    for g_img, w_img in zip(got_lists, want_lists):
        g_img, w_img = sorted(g_img), sorted(w_img)
        assert [d[:2] for d in g_img] == [d[:2] for d in w_img]
        np.testing.assert_array_max_ulp(
            np.float32([d[2] for d in g_img]),
            np.float32([d[2] for d in w_img]), maxulp=1)
