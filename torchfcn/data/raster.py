"""The few OpenCV rasterizers that the hard benchmark draws with, in numpy
on uint8 arrays, so that the port renders its sources without ``cv2``
(the card's host has none).

Each follows OpenCV's 8-bit code path, fixed-point rules included:

* ``hsv2bgr``: ``cv.cvtColor(hsv, cv.COLOR_HSV2BGR)`` of 8-bit HSV (hue
  0-179) in rows of a few pixels: the float32 sector formula, rounded;
  bit-equal;
* ``dilate_2x2``: ``cv.dilate(m, np.ones((2, 2)))``, anchor (1, 1), the
  border outside the image neutral; bit-equal;
* ``fill_poly``: ``cv.fillPoly(m, [pts], color)`` of one polygon with
  integer vertices: the 8-connected outline and the edge-list scan in
  16-bit fixed point; bit-equal;
* ``fill_ellipse``: ``cv.ellipse(m, centre, axes, 0, 0, 360, color, -1)``:
  the ellipse as OpenCV's polygon of table sines, filled by the convex-
  polygon scan with a fixed-point outline; equal but at some pixels on
  the boundary (about 0.013 %);
* ``resize_linear_u8``: ``cv.resize`` with ``INTER_LINEAR``: float32
  sample positions, weights rounded to 11 bits, integer sums and the
  vertical pass's rounding shifts; bit-equal;
* ``resize_cubic_u8``: ``cv.resize`` with ``INTER_CUBIC`` as OpenCV's IPP
  build computes it (a cubic convolution with exact weights): within 1,
  at about 7e-6 of the values.

``tests/test_torch_hardbench.py`` holds each against ``cv2`` over the
sizes the benchmark draws.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# OpenCV's table of sines by degree, 0..450, to 7 decimals
SIN_TABLE = np.array([round(math.sin(math.radians(d)), 7)
                      for d in range(451)], np.float32)
RESIZE_COEF_BITS = 11
RESIZE_COEF_SCALE = 1 << RESIZE_COEF_BITS


# --- colour -------------------------------------------------------------

def hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 HSV, hue in 0..179 -> (..., 3) uint8 BGR as OpenCV's
    per-pixel path computes it (rows narrower than a vector register, such
    as the benchmark's rows of two colours): float32 with s and v scaled by
    1/255, ``1 - s h`` fused (one rounding), the result times 255 rounded
    half to even.  (OpenCV's vector path, on wider rows, truncates.)"""
    hsv = np.asarray(hsv, np.uint8)
    f32, one = np.float32, np.float32(1.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6

    def fused(frac):     # 1 - s * frac, the product exact in float64
        return (1.0 - s.astype(np.float64) * frac).astype(f32)

    tab = np.stack([v, v * (one - s), v * fused(h), v * fused(one - h)],
                   axis=-1)
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                      [2, 1, 0]])[sector]
    bgr = np.take_along_axis(tab, order, axis=-1)
    return np.rint(bgr * f32(255.0)).astype(np.uint8)


# --- morphology -----------------------------------------------------------

def dilate_2x2(m: np.ndarray) -> np.ndarray:
    """2x2 dilation with the anchor at (1, 1): out[y, x] is the max of
    m[y - 1 .. y, x - 1 .. x], pixels outside the image left out."""
    out = m.copy()
    out[1:] = np.maximum(out[1:], m[:-1])
    out[:, 1:] = np.maximum(out[:, 1:], out[:, :-1].copy())
    return out


# --- resizes --------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _cubic_weights(n_in: int, n_out: int):
    """(source indices (n_out, 4), float64 weights (n_out, 4)) of one axis
    of the cubic resize (A = -0.75), indices clamped into the image."""
    d = np.arange(n_out, dtype=np.float64)
    pos = (d + 0.5) * (n_in / n_out) - 0.5
    start = np.floor(pos)
    x = pos - start
    a, x1, r = -0.75, x + 1, 1 - x
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * r - (a + 3)) * r * r + 1
    w = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=-1)
    idx = start.astype(np.int64)[:, None] + np.arange(-1, 3)[None]
    return np.clip(idx, 0, n_in - 1), w


def _linear_taps(n_in: int, n_out: int, rows: bool):
    """(source indices (n_out, 2), 11-bit integer weights (n_out, 2)) of one
    axis of the bilinear resize: float32 sample positions ``(d + 0.5) *
    scale - 0.5``, indices clamped into the image."""
    d = np.arange(n_out, dtype=np.float64)
    pos = ((d + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    start = np.floor(pos).astype(np.int64)
    frac = pos - start.astype(np.float32)
    if not rows:
        # along a row, a sample left of the first pixel or right of the
        # last one takes that pixel alone; rows keep their weights on the
        # clamped rows
        lo, hi = start < 0, start >= n_in - 1
        frac = np.where(lo | hi, np.float32(0), frac)
        start = np.where(lo, 0, np.where(hi, n_in - 1, start))
    w = np.stack([np.float32(1) - frac, frac], axis=-1)
    iw = np.rint(w * np.float32(RESIZE_COEF_SCALE)).astype(np.int64)
    idx = start[:, None] + np.arange(2)[None]
    return np.clip(idx, 0, n_in - 1), iw


def resize_cubic_u8(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv.resize(img, size_wh, interpolation=cv.INTER_CUBIC)`` of a uint8
    (H, W[, C]) image as OpenCV's IPP build computes it: the cubic
    convolution (A = -0.75) with exact weights, rounded."""
    img = np.asarray(img, np.uint8)
    xi, xw = _cubic_weights(img.shape[1], size_wh[0])
    yi, yw = _cubic_weights(img.shape[0], size_wh[1])
    rows = np.einsum("hxk...,xk->hx...", img.astype(np.float64)[:, xi], xw)
    out = np.einsum("ykx...,yk->yx...", rows[yi], yw)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_linear_u8(img: np.ndarray, size_wh: Tuple[int, int]
                     ) -> np.ndarray:
    """``cv.resize(img, size_wh)`` (``INTER_LINEAR``) of a uint8 (H, W[, C])
    image, for sizes that are not an exact halving (which OpenCV computes
    as an area average): integer sums of pixels times 11-bit weights along
    rows; then the vertical pass drops 4 bits of each row sum and 16 of
    each product, and rounds the last 2."""
    img = np.asarray(img, np.uint8)
    xi, xw = _linear_taps(img.shape[1], size_wh[0], rows=False)
    yi, yw = _linear_taps(img.shape[0], size_wh[1], rows=True)
    rows = np.einsum("hxk...,xk->hx...", img.astype(np.int64)[:, xi], xw)
    shape = (-1,) + (1,) * (rows.ndim - 1)
    out = ((yw[:, :1].reshape(shape) * (rows[yi[:, 0]] >> 4)) >> 16) + (
        (yw[:, 1:].reshape(shape) * (rows[yi[:, 1]] >> 4)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


# --- polygons -------------------------------------------------------------

def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line8(m: np.ndarray, p0, p1, color: int) -> None:
    """``cv.line``'s 8-connected integer line from ``p0`` to ``p1``,
    walked left to right: the major axis steps every pixel, the minor one
    when the error term is negative."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x0, y0
    h, w = m.shape[:2]
    for _ in range(dx + 1):
        if 0 <= x < w and 0 <= y < h:
            m[y, x] = color
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def _line_fixed(m: np.ndarray, p0, p1, color: int) -> None:
    """The outline segment of the filled convex polygon between 16-bit
    fixed-point points (after OpenCV's ``Line2``), walked from the left
    (or top) end: along the major axis from that end's pixel (rounded) to
    the other end's (truncated), the minor coordinate stepped from the
    start plus half a pixel by the truncated fixed-point slope."""
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = x1 - x0, y1 - y0
    h, w = m.shape[:2]
    half = XY_ONE >> 1
    steep = abs(dy) >= abs(dx)
    if steep:            # walk rows: swap the roles of x and y
        x0, y0, x1, y1, dx, dy = y0, x0, y1, x1, dy, dx
    if dx < 0:
        x0, y0, x1, y1, dy = x1, y1, x0, y0, -dy
    step = _tdiv(dy << XY_SHIFT, abs(dx) | 1)
    a, b = (x0 + half) >> XY_SHIFT, y0 + half
    for _ in range((x1 >> XY_SHIFT) - a + 1):
        px, py = (b >> XY_SHIFT, a) if steep else (a, b >> XY_SHIFT)
        if 0 <= px < w and 0 <= py < h:
            m[py, px] = color
        a, b = a + 1, b + step


def _fill_convex_fixed(m: np.ndarray, v: Sequence[Tuple[int, int]],
                       color: int) -> None:
    """``FillConvexPoly`` of 16-bit fixed-point vertices: the outline, then
    per row the span between the two edges walked down from the topmost
    vertex, their x stepped by rounded fixed-point slopes."""
    n = len(v)
    half = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line_fixed(m, p0, p, color)
        p0 = p
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    ymin = (min(ys) + half) >> XY_SHIFT
    ymax = (max(ys) + half) >> XY_SHIFT
    xmin = (min(p[0] for p in v) + half) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + half) >> XY_SHIFT
    h, w = m.shape[:2]
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
             dict(idx=imin, di=n - 1, x=-XY_ONE, dx=0, ye=ymin)]
    left = n
    y = ymin
    while True:
        for e in edges:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while left > 0:
                    left -= 1
                    ty = (v[idx][1] + half) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e.update(ye=ty, x=xs, idx=idx,
                                 dx=_tdiv((xe - xs) * 2 + (ty - y),
                                          2 * (ty - y)))
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
                else:
                    left -= 1
        if left < 0:
            break
        if y >= 0:
            lo, hi = sorted((edges[0]["x"], edges[1]["x"]))
            x1, x2 = (lo + half) >> XY_SHIFT, (hi + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                m[y, max(x1, 0):min(x2, w - 1) + 1] = color
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def _ellipse_points(center: Tuple[int, int], axes: Tuple[int, int]):
    """``ellipse2Poly``'s polygon of a full ellipse at angle 0, in 16-bit
    fixed point: a vertex every 5, 18, 30 or 90 degrees by size, from the
    sine table, each rounded to the fixed-point grid; repeats dropped."""
    cx, cy = center[0] << XY_SHIFT, center[1] << XY_SHIFT
    aw, ah = abs(axes[0]) << XY_SHIFT, abs(axes[1]) << XY_SHIFT
    size = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    pts, prev = [], None
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        px = float(cx) + float(aw) * float(SIN_TABLE[450 - a])
        py = float(cy) + float(ah) * float(SIN_TABLE[a])
        pt = []
        for c in (px, py):
            q = int(np.rint(c / XY_ONE)) << XY_SHIFT
            pt.append(q + int(np.rint(c - q)))
        pt = tuple(pt)
        if pt != prev:
            pts.append(pt)
            prev = pt
    return pts


def fill_ellipse(m: np.ndarray, center: Tuple[int, int],
                 axes: Tuple[int, int], color: int = 255) -> np.ndarray:
    """``cv.ellipse(m, center, axes, 0, 0, 360, color, -1)`` in place on a
    2-D uint8 image; returns ``m``."""
    _fill_convex_fixed(m, _ellipse_points(center, axes), color)
    return m


def fill_poly(m: np.ndarray, pts: np.ndarray, color: int = 255
              ) -> np.ndarray:
    """``cv.fillPoly(m, [pts], color)`` of one polygon with integer
    vertices, in place on a 2-D uint8 image; returns ``m``: the 8-connected
    outline, then each row's spans between the edges crossing it (an edge
    covers rows y0 <= y < y1, its x stepped by a truncated 16-bit
    fixed-point slope), filled from the left edge's x rounded to the right
    edge's truncated."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    p0 = pts[-1]
    for p1 in pts:
        _line8(m, p0, p1, color)
        if p0[1] != p1[1]:
            top, bottom = (p0, p1) if p0[1] < p1[1] else (p1, p0)
            dx = _tdiv((p1[0] - p0[0]) << XY_SHIFT, p1[1] - p0[1])
            edges.append((top[1], bottom[1], top[0] << XY_SHIFT, dx))
        p0 = p1
    if len(edges) < 2:
        return m
    h, w = m.shape[:2]
    y_lo = max(min(e[0] for e in edges), 0)
    y_hi = min(max(e[1] for e in edges), h)
    for y in range(y_lo, y_hi):
        xs = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges
                    if y0 <= y < y1)
        for a, b in zip(xs[0::2], xs[1::2]):
            x1, x2 = (a + (XY_ONE >> 1)) >> XY_SHIFT, b >> XY_SHIFT
            if x1 < w and x2 >= 0:
                m[y, max(x1, 0):min(x2, w - 1) + 1] = color
    return m
