"""The port's hard benchmark (``torchfcn/data/hardbench.py``) and its
rasterizers (``torchfcn/data/raster.py``) against ``cv2`` and tpufcn.

Rasterizers, over the sizes the benchmark draws:

* ``hsv2bgr``: bit-equal to ``cv.cvtColor`` over every 8-bit HSV value
  (hue 0-179), in rows of two pixels as the benchmark converts them;
* ``dilate_2x2``, ``fill_poly`` (every triangle of 24-124 px with every
  apex jitter) and ``resize_linear_u8`` (384x512 to each net size):
  bit-equal;
* ``fill_ellipse``: equal but at pixels on the ellipse's boundary (each
  differing pixel has both values among its 3x3 neighbours in cv's mask);
  about 0.013 % of the pixels, stated in ``ELLIPSE_SHARE``;
* ``resize_cubic_u8`` against cv's IPP build: within 1, at a share of the
  values below ``CUBIC_SHARE`` (about 7e-6 measured).

Sources: the same draws as tpufcn's for one seed (the generator's state
after them equal), crops, masks and backgrounds equal to what tpufcn writes
as PNGs but at the values stated.  The device pipeline and the device-
composed held-out set compose on the CPU; the set is cached and
deterministic.
"""

import os

import cv2 as cv
import numpy as np
import pytest
import torch

from tpufcn.core.config import DataConfig as JDataConfig
from tpufcn.data import hardbench as J
from torchfcn.core.config import GridConfig
from torchfcn.data import hardbench as P
from torchfcn.data import raster as R

torch.set_num_threads(2)

# pixels of cv's filled ellipses that the port draws otherwise, all on the
# boundary: at most this share over the benchmark's sizes
ELLIPSE_SHARE = 5e-4
# values of cv's (IPP) cubic upscale that the port's differs from by 1
CUBIC_SHARE = 2e-5


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Pixels with both values among their 3x3 neighbours."""
    m = np.pad(mask > 0, 1, mode="edge")
    h, w = mask.shape
    win = np.stack([m[dy:dy + h, dx:dx + w] for dy in range(3)
                    for dx in range(3)])
    return win.any(0) & ~win.all(0)


def test_hsv2bgr_bit_equal_over_every_value():
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 2, 3)
    assert np.array_equal(R.hsv2bgr(hsv), cv.cvtColor(hsv,
                                                      cv.COLOR_HSV2BGR))


def test_dilate_2x2_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(50):
        h, w = (int(v) for v in rng.integers(1, 130, 2))
        m = (rng.random((h, w)) < 0.1).astype(np.uint8)
        assert np.array_equal(R.dilate_2x2(m),
                              cv.dilate(m, np.ones((2, 2), np.uint8)))


@pytest.mark.parametrize("h0", [24, 25, 26])
def test_fill_poly_triangles_bit_equal(h0):
    for h in range(h0, 125, 3):
        for w in range(24 + h % 2, 125, 2):
            for jx in range(-w // 6, w // 6 + 1):
                pts = np.array([[w // 2 + jx, 0], [0, h - 1],
                                [w - 1, h - 1]], np.int32)
                want = cv.fillPoly(np.zeros((h, w), np.uint8), [pts], 255)
                got = R.fill_poly(np.zeros((h, w), np.uint8), pts)
                assert np.array_equal(got, want), (h, w, jx)


def test_fill_ellipse_differs_only_on_the_boundary():
    differ = total = 0
    for h in range(24, 125):
        for w in range(24 + h % 3, 125, 3):
            want = cv.ellipse(np.zeros((h, w), np.uint8), (w // 2, h // 2),
                              (w // 2 - 1, h // 2 - 1), 0, 0, 360, 255, -1)
            got = R.fill_ellipse(np.zeros((h, w), np.uint8),
                                 (w // 2, h // 2), (w // 2 - 1, h // 2 - 1))
            off = got != want
            assert not (off & ~_boundary(want)).any(), (h, w)
            differ += int(off.sum())
            total += off.size
    assert differ / total <= ELLIPSE_SHARE, differ / total


def test_resize_cubic_within_one_of_cv():
    rng = np.random.default_rng(1)
    differ = total = 0
    for hw in ((192, 256), (384, 512), (96, 96), (128, 128), (32, 32)):
        for _ in range(40):
            small = rng.integers(30, 200, size=(6, 8, 3)).astype(np.uint8)
            want = cv.resize(small, hw[::-1], interpolation=cv.INTER_CUBIC)
            d = np.abs(R.resize_cubic_u8(small, hw[::-1]).astype(int) - want)
            assert d.max() <= 1
            differ += int((d > 0).sum())
            total += d.size
    assert differ / total <= CUBIC_SHARE, differ / total


@pytest.mark.parametrize("hw", [(224, 224), (288, 288), (448, 448),
                                (128, 128), (64, 64)])
def test_resize_linear_bit_equal(hw):
    rng = np.random.default_rng(hw[0])
    for _ in range(3):
        img = rng.integers(0, 256, (384, 512, 3)).astype(np.uint8)
        assert np.array_equal(R.resize_linear_u8(img, hw[::-1]),
                              cv.resize(img, hw[::-1]))


def test_constants_and_config_equal_jax():
    assert (P.SHAPES, P.TEXTURES, P.CLASS_DEFS, P.BOX_CAPACITY) == \
        (J.SHAPES, J.TEXTURES, J.CLASS_DEFS, J.BOX_CAPACITY)
    for classes in (3, 4, 5, 6):
        assert P.distractor_defs(classes) == J.distractor_defs(classes)
    got, want = P.hard_data_config(8), J.hard_data_config(8)
    for field in ("batch_size", "num_compose", "compose_iou_thresh",
                  "scale_range", "compose_max_trials"):
        assert getattr(got, field) == getattr(want, field)
    assert isinstance(want, JDataConfig)


def test_render_object_matches_jax():
    differ = 0
    for i, (shape, tex) in enumerate((s, t) for s in P.SHAPES
                                     for t in P.TEXTURES):
        for h, w in ((40, 56), (88, 33)):
            a = J.render_object(shape, tex, h, w, np.random.default_rng(i))
            b = P.render_object(shape, tex, h, w, np.random.default_rng(i))
            assert np.array_equal(a[0], b[0])
            off = a[1] != b[1]
            assert not (off & ~_boundary(a[1])).any()
            differ += int(off.sum())
    assert differ <= 8, differ


@pytest.fixture(scope="module")
def jax_sources(tmp_path_factory):
    """tpufcn's sources for dataset seed 7, read back from its PNGs as its
    crop library and background loader read them, and its generator's
    state after them."""
    root = str(tmp_path_factory.mktemp("jax_hard"))
    rng = np.random.default_rng(7)
    samples = J.make_hard_dataset(root, rng, classes=4)
    paths = J.make_hard_backgrounds(root, rng, classes=4)
    crops, masks = [], []
    for s in samples:
        x, y, w, h = (int(v) for v in s.rect)
        crops.append(cv.imread(s.image_path)[y:y + h, x:x + w])
        masks.append(cv.imread(s.mask_path, cv.IMREAD_GRAYSCALE)
                     [y:y + h, x:x + w] > 0)
    return dict(crops=crops, masks=masks,
                labels=[s.label for s in samples],
                backgrounds=np.stack([cv.imread(p) for p in paths]),
                state=rng.bit_generator.state)


def test_sources_match_jax(jax_sources, tmp_path):
    src = P.hard_sources(str(tmp_path))
    rng = np.random.default_rng(7)
    P.make_hard_dataset(rng, classes=4)
    P.make_hard_backgrounds(rng, classes=4)
    assert rng.bit_generator.state == jax_sources["state"]
    assert src.labels.tolist() == jax_sources["labels"]
    crop_values = mask_px = 0
    for i, (crop, mask) in enumerate(zip(jax_sources["crops"],
                                         jax_sources["masks"])):
        h, w = crop.shape[:2]
        assert tuple(src.sizes[i]) == (h, w)
        got_mask = src.masks[i, :h, :w]
        off = got_mask != mask
        assert not (off & ~_boundary(mask)).any()
        mask_px += int(off.sum())
        # away from a differing mask pixel, the colour field's cubic
        # upscale is the only difference: within 1
        d = np.abs(src.crops[i, :h, :w].astype(int) - crop)
        assert (d[~off] <= 1).all()
        crop_values += int((d > 0).sum())
    # 32 crops of 339,474 values: 5 values and 2 mask pixels differ on
    # this cv2 build; the bounds leave room for IPP's other CPU paths
    assert crop_values <= 50 and mask_px <= 10, (crop_values, mask_px)
    bg = np.abs(src.backgrounds.astype(int) - jax_sources["backgrounds"])
    # 10 backgrounds of 5.9 M values: 59 differ (distractor ellipse
    # boundaries and the cubic upscale), at most 1 but at ellipse pixels
    assert int((bg > 0).sum()) <= 500, int((bg > 0).sum())
    # the cache gives the same arrays back
    again = P.hard_sources(str(tmp_path))
    for k in ("crops", "masks", "sizes", "labels", "backgrounds"):
        assert np.array_equal(getattr(again, k), getattr(src, k))
    # the backgrounds at the net's size as tpufcn's loader resizes them
    np.testing.assert_array_equal(
        src.backgrounds_at((64, 64))[0],
        cv.resize(src.backgrounds[0], (64, 64)).astype(np.float32))


def test_device_pipeline_and_eval_set_on_cpu(tmp_path):
    grid = GridConfig(64, 64, stride=16, num_classes=4)
    pipe = P.hard_device_pipeline(str(tmp_path), grid, batch_size=4, seed=3,
                                  device="cpu")
    b = pipe.batch(4)
    assert b["image"].shape == (4, 64, 64, 3)
    assert b["rects"].shape == (4, P.BOX_CAPACITY, 4)
    assert int(b["valid"].sum(1).min()) >= 1
    images, gts, segs = P.build_device_eval_set(
        str(tmp_path), grid, classes=4, n_images=10, chunk=4, device="cpu")
    assert images.shape == (10, 64, 64, 3) and images.dtype == np.uint8
    assert segs.shape == (10, 64, 64) and segs.dtype == np.int32
    assert 0 < segs.max() <= 4
    assert len(gts) == 10 and sum(len(g[1]) for g in gts) >= 10
    assert gts[0][0].dtype == np.float32 and gts[0][1].dtype == np.int32
    assert os.path.isfile(P.device_eval_cache_path(str(tmp_path), grid, 4,
                                                   10))
    # the cache, and a fresh root (the same CPU draws), give the same set
    for root in (tmp_path, tmp_path / "fresh"):
        again = P.build_device_eval_set(str(root), grid, classes=4,
                                        n_images=10, chunk=4, device="cpu")
        assert np.array_equal(again[0], images)
        assert np.array_equal(again[2], segs)
        assert all(np.array_equal(a[0], g[0]) and np.array_equal(a[1], g[1])
                   for a, g in zip(again[1], gts))
