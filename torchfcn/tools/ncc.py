"""Normalised cross-correlation template matching on the host, without cv2:
``cv.matchTemplate(search, templ, cv.TM_CCOEFF_NORMED)`` and the maximum
of ``cv.minMaxLoc``.

OpenCV correlates the image with the template (in float32), then
``common_matchTemplate`` subtracts each window's sum times the template's
mean and divides by the window's and the template's spreads, both from
exact integral sums.  Here the correlation is one float64 FFT product and
the rest follows ``common_matchTemplate`` operation by operation, its rule
for flat inputs included: a template of no spread scores 1 everywhere, a
window of (nearly) no spread scores 0, and a ratio that rounding pushed
just past 1 is clamped to +-1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DBL_EPSILON = np.finfo(np.float64).eps
FLT_EPSILON = float(np.finfo(np.float32).eps)


def _box_sums(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Sums of every h x w window of (H, W, C) int64 ``a``:
    (H - h + 1, W - w + 1, C), exact."""
    c = np.zeros((a.shape[0] + 1, a.shape[1] + 1, a.shape[2]), np.int64)
    c[1:, 1:] = a.cumsum(0).cumsum(1)
    return c[h:, w:] - c[:-h, w:] - c[h:, :-w] + c[:-h, :-w]


def match_template_ccoeff_normed(search: np.ndarray,
                                 templ: np.ndarray) -> np.ndarray:
    """Scores of ``templ`` (h, w[, C]) at every position of ``search`` (H,
    W[, C]), both uint8: (H - h + 1, W - w + 1) float32, as
    ``cv.matchTemplate(search, templ, cv.TM_CCOEFF_NORMED)``."""
    img = np.asarray(search)
    t = np.asarray(templ)
    if img.ndim == 2:
        img, t = img[..., None], t[..., None]
    (rows, cols, cn), (h, w) = img.shape, t.shape[:2]
    if t.shape[2] != cn or h > rows or w > cols:
        raise ValueError(f"template {t.shape} does not fit the image "
                         f"{img.shape}")
    out_shape = (rows - h + 1, cols - w + 1)
    inv_area = 1.0 / (h * w)

    # the template's mean and spread (cv.meanStdDev)
    tf = t.astype(np.float64)
    mean = tf.sum((0, 1)) * inv_area
    var = np.maximum((tf * tf).sum((0, 1)) * inv_area - mean * mean, 0.0)
    templ_norm = 0.0
    for sd in np.sqrt(var):
        templ_norm += sd * sd
    if templ_norm < DBL_EPSILON:
        return np.ones(out_shape, np.float32)
    templ_norm = np.sqrt(templ_norm) / np.sqrt(inv_area)

    # the correlation: the image times the flipped template, circularly at
    # the image's size (the valid part wraps nothing)
    fi = np.fft.rfft2(img.astype(np.float64), axes=(0, 1))
    ft = np.fft.rfft2(tf[::-1, ::-1], s=(rows, cols), axes=(0, 1))
    corr = np.fft.irfft2((fi * ft).sum(-1), s=(rows, cols))[h - 1:, w - 1:]

    i64 = img.astype(np.int64)
    sums = _box_sums(i64, h, w).astype(np.float64)
    sq_sums = _box_sums(i64 * i64, h, w).astype(np.float64)
    num = corr
    wnd_mean2 = np.zeros(out_shape)
    wnd_sum2 = np.zeros(out_shape)
    for k in range(cn):
        s = sums[..., k]
        wnd_mean2 += s * s
        num = num - s * mean[k]
        wnd_sum2 += sq_sums[..., k]
    wnd_mean2 *= inv_area
    diff2 = np.maximum(wnd_sum2 - wnd_mean2, 0.0)
    flat = diff2 <= np.minimum(0.5, 10 * FLT_EPSILON * wnd_sum2)
    den = np.where(flat, 0.0, np.sqrt(diff2) * templ_norm)
    mag = np.abs(num)
    ratio = np.divide(num, den, out=np.zeros(out_shape), where=mag < den)
    res = np.where(mag < den, ratio,
                   np.where(mag < den * 1.125, np.where(num > 0, 1.0, -1.0),
                            0.0))
    return res.astype(np.float32)


def min_max_loc(a: np.ndarray
                ) -> Tuple[float, float, Tuple[int, int], Tuple[int, int]]:
    """``cv.minMaxLoc`` of a 2-D array: (min, max, min (x, y), max (x, y)),
    each location the first in row-major order."""
    a = np.asarray(a)
    lo, hi = np.unravel_index(np.argmin(a), a.shape), \
        np.unravel_index(np.argmax(a), a.shape)
    return (float(a[lo]), float(a[hi]), (int(lo[1]), int(lo[0])),
            (int(hi[1]), int(hi[0])))
