"""The float32 filters, warps and conversions of the port's photometric chain
(``torchfcn/data/raster.py``, ``torchfcn/data/manifest.py::bgr2gray_u8``)
against ``cv2`` 5.0, value for value.

OpenCV sums a float32 filter's taps in an order that depends on the kernel
size and on the position in the row (vector code over the row's head,
scalar code over its tail), with fused multiply-adds in places.  Each test
covers rows whose length in values is and is not a multiple of 8 and 16,
one and three channels, and the kernel sizes the photometric chain draws:
Gaussian kernels of 3, 5, 7, 11 and 23 taps (sigma 0.25, 0.44, 0.6, 1.1,
2.7), boxes of 2 to 7, the sharpen kernel, medians of 3, 5 and 7.  Every
function is equal to cv2 on every value; the controls (another tap order,
the 7-tap order on a 5-tap kernel, unfused sums, an off-by-one gray
coefficient) must differ on some, so that equality is not vacuous.
"""

from fractions import Fraction

import cv2 as cv
import numpy as np
import pytest

from torchfcn.data import raster as R
from torchfcn.data.manifest import bgr2gray_u8

SHAPES = [(37, 53, 3), (31, 59, 3), (44, 27, 3), (48, 64, 3), (52, 61, 1),
          (9, 7, 3), (3, 4, 3)]
SIGMAS = [0.25, 0.44, 0.6, 1.1, 2.7]


def _image(shape, seed, integral=True):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.float32) if integral else \
        (rng.random(shape) * 255).astype(np.float32)
    return img[..., 0] if shape[-1] == 1 else img


def _sharpen(seed):
    lightness = np.random.default_rng(seed).uniform(0.75, 1.5)
    return np.array([[-1, -1, -1], [-1, 8 + lightness, -1], [-1, -1, -1]],
                    np.float32)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_gaussian_blur_equal_to_cv(sigma):
    assert R.gaussian_ksize(sigma) == {0.25: 3, 0.44: 5, 0.6: 7, 1.1: 11,
                                       2.7: 23}[sigma]
    for i, shape in enumerate(SHAPES):
        for integral in (True, False):
            img = _image(shape, i, integral)
            want = cv.GaussianBlur(img, (0, 0), sigma)
            got = R.gaussian_blur_f32(img, sigma)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.array_equal(got, want), (shape, integral)
    n = R.gaussian_ksize(sigma)
    np.testing.assert_array_equal(
        R.gaussian_kernel_f32(n, sigma),
        cv.getGaussianKernel(n, sigma, cv.CV_32F).ravel())


def test_gaussian_blur_random_sizes_and_sigmas():
    rng = np.random.default_rng(5)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(2, 70, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
        sigma = float(rng.uniform(0.002, 3.0))
        assert np.array_equal(R.gaussian_blur_f32(img, sigma),
                              cv.GaussianBlur(img, (0, 0), sigma)), (h, w,
                                                                     sigma)


def _rows_in_order(img, sigma):
    """Control: the 7-tap kernels' row order (taps fused one after another
    from 0) on every kernel, the column pass as the port's."""
    n = R.gaussian_ksize(sigma)
    w, r = R.gaussian_kernel_f32(n, sigma), n // 2
    x = R._line_taps(img, -r, r)
    rows = np.zeros_like(x[0])
    for k in range(n):
        rows = R.fma_f32(x[k], w[k], rows)
    y = R._row_taps(rows, -r, r)
    out = y[r] * w[r]
    for i in range(1, r + 1):
        out = R.fma_f32(y[r - i] + y[r + i], w[r + i], out)
    return out.reshape(img.shape)


def test_gaussian_controls_differ():
    """The 5-tap kernel summed in the 7-tap kernels' order, and an unfused
    row pass, each differ from cv2 on some values."""
    img = _image((48, 64, 3), 1, integral=False)
    want = cv.GaussianBlur(img, (0, 0), 0.44)
    assert np.array_equal(R.gaussian_blur_f32(img, 0.44), want)
    assert int((_rows_in_order(img, 0.44) != want).sum()) > 0
    w = R.gaussian_kernel_f32(7, 0.6)
    plain = cv.sepFilter2D(img, -1, w, np.ones(1, np.float32))
    x = R._line_taps(img, -3, 3)
    unfused = x[0] * w[0]
    for k in range(1, 7):
        unfused = unfused + x[k] * w[k]
    assert int((unfused.reshape(img.shape) != plain).sum()) > 0


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6, 7])
def test_box_blur_equal_to_cv(k):
    for i, shape in enumerate(SHAPES):
        for integral in (True, False):
            img = _image(shape, i, integral)
            assert np.array_equal(R.box_blur_f32(img, k),
                                  cv.blur(img, (k, k))), (shape, integral)


def test_filter2d_sharpen_equal_to_cv():
    for i, shape in enumerate(SHAPES):
        kern = _sharpen(i)
        for img in (_image(shape, i), _image(shape, i, False),
                    cv.GaussianBlur(_image(shape, i), (0, 0), 1.3)):
            assert np.array_equal(R.filter2d_3x3_f32(img, kern),
                                  cv.filter2D(img, -1, kern)), shape
    # control: every tap's product rounded before its add
    img, kern = _image((48, 64, 3), 3, False), _sharpen(3)
    taps = [t for line in R._line_taps(img, -1, 1)
            for t in R._row_taps(line, -1, 1)]
    taps = taps[0::3] + taps[1::3] + taps[2::3]
    unfused = sum(t * w for t, w in zip(taps, kern.ravel()))
    assert int((unfused.reshape(img.shape)
                != cv.filter2D(img, -1, kern)).sum()) > 0


@pytest.mark.parametrize("k", [3, 5, 7])
def test_median_blur_equal_to_cv(k):
    for i, shape in enumerate(SHAPES):
        img = _image(shape, i).astype(np.uint8)
        assert np.array_equal(R.median_blur_u8(img, k),
                              cv.medianBlur(img, k)), shape


def test_resize_nearest_equal_to_cv():
    rng = np.random.default_rng(0)
    for _ in range(80):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        size = tuple(int(v) for v in rng.integers(1, 200, 2))
        assert np.array_equal(
            R.resize_nearest_u8(img, size),
            cv.resize(img, size, interpolation=cv.INTER_NEAREST)), (h, w,
                                                                    size)


@pytest.mark.parametrize("nearest", [False, True])
def test_rotation_and_warp_affine_equal_to_cv(nearest):
    rng = np.random.default_rng(int(nearest))
    flags = cv.INTER_NEAREST if nearest else cv.INTER_LINEAR
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(5, 120, 2))
        shape = (h, w, 3) if rng.random() < 0.7 else (h, w)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        angle = float(rng.integers(-5, 6))
        m = R.get_rotation_matrix_2d((w / 2, h / 2), angle, 1)
        assert np.array_equal(m, cv.getRotationMatrix2D((w / 2, h / 2),
                                                        angle, 1))
        assert np.array_equal(R.warp_affine_u8(img, m, (w, h), nearest),
                              cv.warpAffine(img, m, (w, h), flags=flags)), (
            shape, angle)


def test_bgr2gray_equal_to_cv_on_every_colour():
    b, g, r = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                          indexing="ij")
    img = np.stack([b, g, r], -1).astype(np.uint8).reshape(-1, 256, 3)
    want = cv.cvtColor(img, cv.COLOR_BGR2GRAY)
    assert np.array_equal(bgr2gray_u8(img), want)
    # control: OpenCV 4's 14-bit coefficients
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    old = (b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14
    assert int((old != want).sum()) > 0


def _exact_fma(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once, from the exact rational."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    lo, hi = sorted((near, np.nextafter(near, np.float32(
        np.inf if Fraction(float(near)) < exact else -np.inf))))
    dlo = exact - Fraction(float(lo))
    dhi = Fraction(float(hi)) - exact
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def test_fma_f32_rounds_once():
    """Against the exact rational on random values and on sums that fall
    exactly half-way between two float32 values in float64 but not
    exactly (where two roundings go wrong)."""
    rng = np.random.default_rng(0)
    a = (rng.random(3000) * 300 - 50).astype(np.float32)
    b = rng.choice([np.float32(1e-4), np.float32(0.37), np.float32(-1),
                    np.float32(3.3e-3)], 3000).astype(np.float32)
    c = (rng.random(3000) * 300).astype(np.float32)
    # a * b = +-(2^-24 - 2^-64): added to 1 + 2^-23 the exact sums lie
    # 2^-64 off the float32 midpoints 1 + 2^-24 and 1 + 3 * 2^-24, where
    # float64 rounds them
    tie_a = np.array([-(2.0 ** -24) * (1 + 2.0 ** -20),
                      (2.0 ** -24) * (1 + 2.0 ** -20)], np.float32)
    tie_b = np.array([1 - 2.0 ** -20] * 2, np.float32)
    tie_c = np.array([1 + 2.0 ** -23] * 2, np.float32)
    a, b, c = (np.concatenate([u, v]) for u, v in ((a, tie_a), (b, tie_b),
                                                  (c, tie_c)))
    got = R.fma_f32(a, b, c)
    want = np.array([_exact_fma(*v) for v in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    # control: two roundings (float64, then float32) miss the tie cases
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert int((twice != want).sum()) > 0
