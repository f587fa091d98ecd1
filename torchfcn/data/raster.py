"""The OpenCV rasterizers and filters that the port draws with, in numpy on
uint8 arrays, so that it renders without ``cv2`` (the card's host has
none).

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

And two that the offline augmentation of the record writer uses
(``torchfcn.data.records.offline_variants``):

* ``gaussian_blur_u8``: ``cv.GaussianBlur(img, (kx, ky), 0)`` of uint8 for
  kernel sizes 3, 5 and 7: OpenCV's fixed tables of small kernels, its
  8-bit fixed-point separable filter, BORDER_REFLECT_101; bit-equal;
* ``flip`` and ``flip_image_with_rects``: ``cv.flip`` and the reference's
  rect transform, copied from ``tpufcn/data/compositor.py``.

And those of the host compositor's photometric chain, rotation and
resizes (``torchfcn.data.compositor``), equal to cv2 5.0 on every value
that ``tests/test_torch_cv_filters.py`` tests, each float32 sum in
OpenCV's order with its fused multiply-adds (``fma_f32``):
``gaussian_blur_f32`` (``cv.GaussianBlur(img, (0, 0), sigma)``),
``box_blur_f32`` (``cv.blur``), ``filter2d_3x3_f32`` (``cv.filter2D``),
``median_blur_u8`` (``cv.medianBlur``), ``resize_nearest_u8``
(``INTER_NEAREST``), ``get_rotation_matrix_2d`` and ``warp_affine_u8``
(``cv.warpAffine``, bilinear or nearest, OpenCV 5's float32 mapping).

And two that the tiled segmenter of the stream surface uses
(``torchfcn.serve.stream``):

* ``resize_linear_f32``: ``cv.resize`` with ``INTER_LINEAR`` of a float32
  image with 1 or 3 channels;
* ``largest_contour_rect``: the bounding box of the largest contour of a
  mask (``cv.findContours`` + ``cv.contourArea`` + ``cv.boundingRect``).

And those of the detection overlay (``torchfcn.serve.viz``), as cv2 5.0
draws with ``LINE_8``, bit-equal: ``line`` (with ``clip_line``),
``fill_convex_poly`` (its outline ``line`` or, with 16 fractional bits,
``line_fixed``), ``fill_circle``, ``thick_line``, ``rectangle`` (filled
or outlined), ``put_text`` (``FONT_HERSHEY_PLAIN``
from ``torchfcn.data.hershey``), ``add_weighted_u8`` and
``apply_colormap_jet``.

``tests/test_torch_hardbench.py`` holds the first six against ``cv2`` over
the sizes the benchmark draws, ``tests/test_torch_stream.py`` the two
after them, ``tests/test_torch_records.py`` the last two,
``tests/test_torch_viz.py`` the overlay's.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

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


def _linear_taps_f32(n_in: int, n_out: int):
    """(source indices (n_out, 2), float32 fractions (n_out,)) of one axis
    of the float bilinear resize: sample positions ``(d + 0.5) * scale -
    0.5`` in float64, a sample outside the pixel centres taking the edge
    pixel alone."""
    d = np.arange(n_out, dtype=np.float64)
    pos = (d + 0.5) * (n_in / n_out) - 0.5
    start = np.floor(pos).astype(np.int64)
    frac = pos - start
    lo, hi = start < 0, start >= n_in - 1
    frac = np.where(lo | hi, 0.0, frac).astype(np.float32)
    start = np.where(lo, 0, np.where(hi, n_in - 1, start))
    idx = start[:, None] + np.arange(2)[None]
    return np.clip(idx, 0, n_in - 1), frac


def _lerp_fma(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 ``a + (b - a) * t`` with the multiply-add fused: the exact
    product in float64, one rounding to float32 (a float32 product is exact
    in float64)."""
    return ((b - a).astype(np.float64) * t + a).astype(np.float32)


def resize_linear_f32(img: np.ndarray, size_wh: Tuple[int, int]
                      ) -> np.ndarray:
    """``cv.resize(img, size_wh)`` (``INTER_LINEAR``) of a float32 (H, W)
    or (H, W, 1 | 3) image, as OpenCV's IPP build computes it: rows first,
    each pass ``a + (b - a) * t`` with the multiply-add fused, half-pixel
    sample positions, the border clamped in both passes.  One channel
    comes back (H, W), as cv2 returns it.

    Bit-equal to cv2 5.0 on one channel.  On three channels IPP leaves the
    multiply-add unfused at some positions that depend on the vector lanes
    (not recovered): up to about 2 % of the values differ there, by at most
    an ulp of the image's largest value (``tests/test_torch_stream.py``
    bounds both)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"resize_linear_f32 takes (H, W) or (H, W, 1 | 3), "
                         f"got {img.shape}")
    xi, fx = _linear_taps_f32(img.shape[1], size_wh[0])
    yi, fy = _linear_taps_f32(img.shape[0], size_wh[1])
    tx = fx.reshape((1, -1) + (1,) * (img.ndim - 2))
    rows = _lerp_fma(img[:, xi[:, 0]], img[:, xi[:, 1]], tx)
    ty = fy.reshape((-1,) + (1,) * (img.ndim - 1))
    return _lerp_fma(rows[yi[:, 0]], rows[yi[:, 1]], ty)


# --- contours -------------------------------------------------------------

# the 8 neighbours, counter-clockwise on the screen from the right (x, y
# with y down), as OpenCV's border follower numbers them
_DIRS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _outer_border(fg: np.ndarray, x0: int, y0: int) -> list:
    """The outer border of the 8-connected component whose first pixel in
    raster order is (x0, y0), as OpenCV's border follower (Suzuki and Abe)
    walks it: every border pixel in turn, a pixel visited again where the
    component narrows to one pixel.  ``fg`` is padded with zeros."""
    def on(s, x, y):
        dx, dy = _DIRS[s & 7]
        return fg[y + dy, x + dx]

    s = 4                                   # the background pixel left
    for _ in range(7):
        s = (s - 1) & 7                     # clockwise from the left
        if on(s, x0, y0):
            break
    else:
        return [(x0, y0)]                   # a single pixel
    x1, y1 = x0 + _DIRS[s][0], y0 + _DIRS[s][1]
    pts = []
    x3, y3 = x0, y0
    while True:
        # counter-clockwise from the direction after the previous pixel
        for _ in range(8):
            s += 1
            if on(s, x3, y3):
                break
        s &= 7
        pts.append((x3, y3))
        x4, y4 = x3 + _DIRS[s][0], y3 + _DIRS[s][1]
        if (x4, y4) == (x0, y0) and (x3, y3) == (x1, y1):
            return pts
        x3, y3 = x4, y4
        s = (s + 4) & 7


def contour_area(pts) -> float:
    """``cv.contourArea``: the shoelace area of the closed polygon."""
    if len(pts) < 3:
        return 0.0
    p = np.asarray(pts, np.float64)
    x, y = p[:, 0], p[:, 1]
    return abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
                     )) / 2


def largest_contour_rect(mask: np.ndarray, area_zero: bool = False
                         ) -> Optional[Tuple[int, int, int, int]]:
    """``cv.boundingRect`` of the largest contour by ``cv.contourArea``
    that ``cv.findContours(mask > 0, RETR_CCOMP, CHAIN_APPROX_SIMPLE)``
    finds, as (x, y, w, h), or None when there is none or its area is 0
    (with ``area_zero``, None only when there is none: where every contour
    encloses no area, ``max(contours, key=cv.contourArea)`` takes cv2's
    first).

    The largest contour is always an outer border: a hole's border lies
    inside its component's outer border, and where the two enclose the
    same area (a ring one pixel wide) they have the same box.  So this
    traces only the outer border of each 8-connected component
    (``scipy.ndimage.label``) and boxes the component with the largest
    area.  Equal areas go to the component whose first pixel comes last in
    raster order, as cv2 lists its contours, latest found first."""
    from scipy import ndimage
    fg = np.asarray(mask) > 0
    labels, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    if n == 0:
        return None
    padded = np.pad(fg, 1)
    # each component's first pixel in raster order
    flat = labels.ravel()
    order = np.flatnonzero(flat)
    first = np.full(n + 1, -1, np.int64)
    first[flat[order[::-1]]] = order[::-1]
    best, best_area = None, 0.0
    w = fg.shape[1]
    order = np.argsort(first[1:])[::-1] + 1
    if area_zero:
        best = order[0]
    for lab in order:
        y0, x0 = divmod(int(first[lab]), w)
        area = contour_area(_outer_border(padded, x0 + 1, y0 + 1))
        if area > best_area:
            best, best_area = lab, area
    if best is None:
        return None
    ys, xs = np.nonzero(labels == best)
    return (int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
            int(ys.max() - ys.min() + 1))


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
    vertex, their x stepped by rounded fixed-point slopes.  The hard
    benchmark's ellipses keep this walk, not the exact
    ``fill_convex_poly``: the gates' recorded readings rest on the sources
    it draws (ROADMAP Queue 3 item 2)."""
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


# --- offline augmentation -------------------------------------------------

# OpenCV's Gaussian kernels for sigma <= 0 and sizes 3, 5, 7, in 8-bit
# fixed point (getGaussianKernelBitExact of its small-kernel table: exact)
SMALL_GAUSSIAN_U8 = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
                     7: (8, 28, 56, 72, 56, 28, 8)}


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """cv.borderInterpolate(idx, n, BORDER_REFLECT_101)."""
    if n == 1:
        return np.zeros_like(idx)
    idx = np.array(idx)
    while True:
        lo, hi = idx < 0, idx >= n
        if not (lo.any() or hi.any()):
            return idx
        idx = np.where(lo, -idx, np.where(hi, 2 * n - 2 - idx, idx))


def gaussian_blur_u8(img: np.ndarray, ksize: Tuple[int, int]) -> np.ndarray:
    """``cv.GaussianBlur(img, ksize, 0)`` of a uint8 (H, W[, C]) image for odd
    kernel sizes (kx, ky) of 3 to 7: each pixel times its 8-bit kernel weight
    along rows (exact), the row sums times the column weights, rounded
    from 16 fractional bits; the border reflected without its edge pixel."""
    kx, ky = (int(k) for k in ksize)
    if kx not in SMALL_GAUSSIAN_U8 or ky not in SMALL_GAUSSIAN_U8:
        raise ValueError(f"gaussian_blur_u8 takes kernel sizes 3, 5 or 7, "
                         f"got {ksize}")
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    p = img.astype(np.int64)
    rows = 0
    for i, wt in enumerate(SMALL_GAUSSIAN_U8[kx]):
        rows = rows + wt * p[:, _reflect101(np.arange(w) + i - kx // 2, w)]
    out = 0
    for j, wt in enumerate(SMALL_GAUSSIAN_U8[ky]):
        out = out + wt * rows[_reflect101(np.arange(h) + j - ky // 2, h)]
    return ((out + (1 << 15)) >> 16).astype(np.uint8)


def flip(image: np.ndarray, flip_code: int) -> np.ndarray:
    """``cv.flip(image, flip_code)``: 0 rows reversed, > 0 columns, < 0
    both."""
    if flip_code == 0:
        im = image[::-1]
    elif flip_code > 0:
        im = image[:, ::-1]
    else:
        im = image[::-1, ::-1]
    return np.ascontiguousarray(im)


def flip_image_with_rects(image: np.ndarray, rects, flip_code: int):
    """``flip(image, flip_code)`` and the reference rect transform
    (argumentation_engine.py:241-267), including its -1 pixel shifts
    (``tpufcn/data/compositor.py:69``)."""
    im = flip(image, flip_code)
    h, w = image.shape[:2]
    out = []
    for rect in rects:
        x, y, rw, rh = [int(v) for v in rect]
        p1 = (x, y)
        p2 = (x + rw, y + rh)
        if flip_code == -1:
            p1 = (w - p1[0] - 1, h - p1[1] - 1)
            p2 = (w - p2[0] - 1, h - p2[1] - 1)
        elif flip_code == 0:
            p1 = (p1[0], h - p1[1] - 1)
            p2 = (p2[0], h - p2[1] - 1)
        elif flip_code == 1:
            p1 = (w - p1[0] - 1, p1[1])
            p2 = (w - p2[0] - 1, p2[1])
        nx = max(min(p1[0], p2[0]), 0)
        ny = max(min(p1[1], p2[1]), 0)
        out.append([nx, ny, abs(p2[0] - p1[0]), abs(p2[1] - p1[1])])
    return im, out


# --- the photometric chain's float32 filters ------------------------------
#
# OpenCV filters a float32 image row by row, each row as one line of
# ``W * C`` values: vector code over the leading part of the line, scalar
# code over its tail.  The two sum their taps in different orders (the
# vector code with fused multiply-adds), so each function below takes the
# line's split point from cv2's own loops and computes each part in its
# order.  ``fma_f32`` is the fused multiply-add, rounded once.


def fma_f32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.  The
    product is exact in float64 and the sum is rounded to float64, then to
    float32.  That rounds twice only where the float64 sum falls exactly
    half-way between two float32 values (its 29 low mantissa bits
    ``1 << 28``); there the rounding error of the float64 sum (two-sum)
    breaks the tie as the exact sum would."""
    s = np.multiply(a, b, dtype=np.float64)
    if np.shape(c) == s.shape:
        np.add(s, c, out=s)
    else:
        s = s + np.asarray(c, np.float64)
    r = s.astype(np.float32)
    bits = s.view(np.int64)
    np.bitwise_and(bits, 0x1FFFFFFF, out=bits)
    tie = np.flatnonzero(bits == 0x10000000)
    if tie.size:
        def pick(v):
            v = np.asarray(v)
            if v.ndim == 0:
                return v
            return np.broadcast_to(v, r.shape).reshape(-1)[tie]

        p = np.multiply(pick(a), pick(b), dtype=np.float64)
        c = pick(c).astype(np.float64)
        s = p + c
        bb = s - p
        err = (p - (s - bb)) + (c - bb)
        flat = r.reshape(-1)
        fixed = flat[tie]
        toward = np.where(err > 0, np.float32(np.inf), np.float32(-np.inf))
        away = (err != 0) & ((s > fixed) == (err > 0))
        fixed[away] = np.nextafter(fixed[away], toward[away])
        flat[tie] = fixed
    return r


def _as_lines(img: np.ndarray) -> np.ndarray:
    """(H, W[, C]) -> (H, W * C): each image row as the line OpenCV walks."""
    return np.ascontiguousarray(img).reshape(img.shape[0], -1)


def _line_taps(img: np.ndarray, lo: int, hi: int) -> list:
    """The lines of ``img`` (``_as_lines``) shifted along the columns by lo ..
    hi pixels, the border reflected: views into one padded copy."""
    w = img.shape[1]
    c = img.shape[2] if img.ndim == 3 else 1
    padded = _as_lines(np.take(img, _reflect101(np.arange(lo, w + hi), w),
                               axis=1))
    return [padded[:, k * c:(k + w) * c] for k in range(hi - lo + 1)]


def _row_taps(lines: np.ndarray, lo: int, hi: int) -> list:
    """``lines`` shifted along the rows by lo .. hi, the border reflected:
    views into one padded copy."""
    h = lines.shape[0]
    padded = np.take(lines, _reflect101(np.arange(lo, h + hi), h), axis=0)
    return [padded[k:k + h] for k in range(hi - lo + 1)]


def box_blur_f32(img: np.ndarray, k: int) -> np.ndarray:
    """``cv.blur(img, (k, k))`` of a float32 (H, W[, C]) image, k of 2 to 7,
    the anchor at k // 2: the window summed in float64 (rows, then
    columns), times ``1 / (k * k)`` in float64, rounded to float32."""
    img = np.asarray(img, np.float32)
    a = k // 2
    rows = 0
    for t in _line_taps(img, -a, k - 1 - a):
        rows = rows + t.astype(np.float64)
    out = 0
    for t in _row_taps(rows, -a, k - 1 - a):
        out = out + t
    return (out * (1.0 / (k * k))).astype(np.float32).reshape(img.shape)


def filter2d_3x3_f32(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """``cv.filter2D(img, -1, kern)`` of a float32 (H, W[, C]) image with a
    3x3 float32 kernel free of zeros: the 9 taps in row-major order, from
    0.  The vector code (each line's first ``8 * (L // 8)`` values) fuses
    each multiply-add; the scalar tail rounds each product first."""
    img = np.asarray(img, np.float32)
    kern = np.asarray(kern, np.float32)
    taps = [t for line in _line_taps(img, -1, 1)
            for t in _row_taps(line, -1, 1)]
    taps = taps[0::3] + taps[1::3] + taps[2::3]    # row-major order
    head = 8 * (taps[0].shape[1] // 8)
    out = np.zeros_like(taps[0])
    tail = out[:, head:].copy()
    for t, w in zip(taps, kern.ravel()):
        out = fma_f32(t, w, out)
        tail = tail + t[:, head:] * w
    out[:, head:] = tail
    return out.reshape(img.shape)


def gaussian_kernel_f32(ksize: int, sigma: float) -> np.ndarray:
    """``cv.getGaussianKernel(ksize, sigma, cv.CV_32F)`` for sigma > 0 and
    an odd ksize: ``exp(-x^2 / (2 sigma^2))`` in float64 over x = ksize // 2
    .. 1, its sum doubled plus the centre's 1, each weight times the
    sum's reciprocal, rounded to float32."""
    n2 = (ksize - 1) // 2
    x = np.arange(1 - ksize, 0, 2, dtype=np.float64)
    values = np.exp(x * x * (-0.125 / (sigma * sigma)))
    total = 0.0
    for v in values:
        total += v
    mul = 1.0 / (total * 2 + 1.0)
    side = values * mul
    return np.concatenate([side, [mul], side[::-1]]).astype(np.float32) \
        if n2 else np.array([1.0], np.float32)


def gaussian_ksize(sigma: float) -> int:
    """OpenCV's kernel size for a float image and ``ksize=(0, 0)``:
    ``round(8 sigma + 1) | 1``."""
    return int(np.rint(sigma * 8 + 1)) | 1


def gaussian_blur_f32(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv.GaussianBlur(img, (0, 0), sigma)`` of a float32 (H, W[, C]) image,
    separable, rows first (``gaussian_kernel_f32``, ``gaussian_ksize``).

    Along the rows, kernels of 3 and 5 taps (OpenCV's small symmetric
    filter) take the centre times its weight fused onto the sum of the
    nearest pair times its weight, then (5 taps) the outer pair fused on;
    a line of odd length ends in one value: the centre times its weight,
    then each pair times its weight added on (fused for 3 taps, each
    product rounded for 5).  Longer kernels fuse tap after tap from
    0, tap order, over each line's first ``4 * (L // 4)`` values; over the
    rest, the scalar loop (unrolled by 4 over taps 1 .. n - 1) rounds each
    product but fuses the taps past the last whole group of 4.  Along the
    columns: the centre
    times its weight, then each pair (inner first) fused on, except past
    ``8 * (L // 8)`` of kernels longer than 3, where each product is
    rounded.

    Equal to cv2 5.0 on images of at least 2 x 2 pixels (cv2 takes other
    paths on a single row or column)."""
    img = np.asarray(img, np.float32)
    n = gaussian_ksize(sigma)
    if n == 1:
        return img.copy()
    w = gaussian_kernel_f32(n, sigma)
    r = n // 2
    x = _line_taps(img, -r, r)
    L = x[0].shape[1]

    def symmetric(taps, lo, fused):
        """The centre, then each pair fused on (or each product rounded)
        over the line's values from ``lo`` on."""
        acc = taps[r][:, lo:] * w[r]
        for i in range(1, r + 1):
            pair = taps[r - i][:, lo:] + taps[r + i][:, lo:]
            acc = fma_f32(pair, w[r + i], acc) if fused else \
                acc + pair * w[r + i]
        return acc

    if n <= 5:
        rows = fma_f32(x[r], w[r], (x[r - 1] + x[r + 1]) * w[r + 1])
        if n == 5:
            rows = fma_f32(x[0] + x[4], w[4], rows)
        if L % 2:
            rows[:, L - 1:] = symmetric(x, L - 1, n == 3)
    else:
        head = 4 * (L // 4)
        rows = x[0] * w[0]
        tail = rows[:, head:].copy()
        for k in range(1, n):
            rows = fma_f32(x[k], w[k], rows)
            if k > 4 * ((n - 1) // 4):
                tail = fma_f32(x[k][:, head:], w[k], tail)
            else:
                tail = tail + x[k][:, head:] * w[k]
        rows[:, head:] = tail
    y = _row_taps(rows, -r, r)
    out = symmetric(y, 0, True)
    if n > 3:
        head = 8 * (L // 8)
        out[:, head:] = symmetric(y, head, False)
    return out.reshape(img.shape)


def median_blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """``cv.medianBlur(img, k)`` of a uint8 (H, W[, C]) image, k of 3, 5 or
    7: each channel's median over the k x k window, the border replicated."""
    img = np.asarray(img, np.uint8)
    a = k // 2
    pad = [(a, a), (a, a)] + [(0, 0)] * (img.ndim - 2)
    win = np.lib.stride_tricks.sliding_window_view(
        np.pad(img, pad, mode="edge"), (k, k), axis=(0, 1))
    win = win.reshape(img.shape + (k * k,))
    return np.partition(win, k * k // 2, axis=-1)[..., k * k // 2]


def resize_nearest_u8(img: np.ndarray, size_wh: Tuple[int, int]
                      ) -> np.ndarray:
    """``cv.resize(img, size_wh, interpolation=cv.INTER_NEAREST)``: output
    pixel d takes source pixel ``floor(d / (out / in))`` (the reciprocal in
    float64, as OpenCV takes it), clamped into the image."""
    img = np.asarray(img)

    def taps(n_in, n_out):
        inv = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64),
                          n_in - 1)

    return img[taps(img.shape[0], size_wh[1])][:, taps(img.shape[1],
                                                        size_wh[0])]


# --- rotation -------------------------------------------------------------

def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv.getRotationMatrix2D(center, angle, scale)``: the (2, 3) float64
    affine matrix of a rotation by ``angle`` degrees (counter-clockwise on
    the screen) about ``center`` (taken as float32, as OpenCV's Point2f)."""
    cx, cy = (float(np.float32(c)) for c in center)
    rad = angle * (math.pi / 180)
    alpha = math.cos(rad) * scale
    beta = math.sin(rad) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a (2, 3) affine map as ``cv.warpAffine`` computes it
    (float64, the determinant's reciprocal first), flattened to 6."""
    m = np.asarray(m, np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine_u8(img: np.ndarray, m: np.ndarray, size_wh: Tuple[int, int],
                   nearest: bool = False) -> np.ndarray:
    """``cv.warpAffine(img, m, size_wh)`` of a uint8 (H, W[, C]) image,
    ``INTER_LINEAR`` (or ``INTER_NEAREST``), pixels outside the source 0.

    OpenCV 5 maps each output pixel back in float32: the inverse matrix
    rounded to float32, the source position ``x * M0 + (y * M1 + M2)`` with
    the first multiply-add fused over each row's first ``16 * (W // 16)``
    pixels (its vector loop) and ``(x * M0 + y * M1) + M2`` with the first
    one fused past them (the scalar loop); then the four neighbours
    interpolated in float32, ``p0 + a * (p1 - p0)`` fused, along x and then
    along y, and rounded half to even (nearest: the position rounded half
    to even)."""
    img = np.asarray(img, np.uint8)
    f32 = np.float32
    M = _invert_affine(m).astype(f32)
    W, H = size_wh
    h, w = img.shape[:2]
    head = 16 * (W // 16)
    x = np.broadcast_to(np.arange(W, dtype=f32)[None], (H, W))
    y = np.arange(H, dtype=f32)[:, None]

    def source(m0, m1, m2):
        yw = np.broadcast_to(y * m1, (H, W))
        vec = fma_f32(x[:, :head], m0, yw[:, :head] + m2)
        tail = fma_f32(x[:, head:], m0, yw[:, head:]) + m2
        return np.concatenate([vec, tail], axis=1)

    sx, sy = source(M[0], M[1], M[2]), source(M[3], M[4], M[5])

    def pixels(iy, ix):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = img[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
        if img.ndim == 3:
            inside = inside[..., None]
        return np.where(inside, v, 0).astype(f32)

    if nearest:
        return pixels(np.rint(sy).astype(np.int64),
                      np.rint(sx).astype(np.int64)).astype(np.uint8)
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = sx - ix, sy - iy
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    p00, p01 = pixels(iy, ix), pixels(iy, ix + 1)
    p10, p11 = pixels(iy + 1, ix), pixels(iy + 1, ix + 1)
    top = fma_f32(ax, p01 - p00, p00)
    bottom = fma_f32(ax, p11 - p10, p10)
    out = fma_f32(ay, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


# --- the overlay's drawing (imgproc/drawing.cpp, LINE_8) -----------------
#
# What ``torchfcn.serve.viz`` draws with: OpenCV's 8-connected rasterizers
# on uint8 images of 1 or 3 channels, ``color`` a scalar or a tuple of one
# value per channel.  Points are integers; ``shift`` gives their fractional
# bits, as in cv2.  Every function draws in place.

def clip_line(size_wh: Tuple[int, int], p1: Tuple[int, int],
              p2: Tuple[int, int]):
    """``cv::clipLine`` of a segment to [0, w - 1] x [0, h - 1] (int64
    ends, double intersections truncated): (inside, p1, p2)."""
    right, bottom = size_wh[0] - 1, size_wh[1] - 1
    if size_wh[0] <= 0 or size_wh[1] <= 0:
        return False, p1, p2
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int],
         color) -> None:
    """``cv.line(img, p1, p2, color)`` (thickness 1, LINE_8, no shift):
    the segment clipped to the image (``clip_line``) when an end lies
    outside, then ``LineIterator``'s walk from its left end."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        inside, p1, p2 = clip_line((w, h), p1, p2)
        if not inside:
            return
    (x, y), dx, dy = p1, p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        (x, y), dx, dy = p2, -dx, -dy
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    n = dx + 1
    k = np.arange(n, dtype=np.int64)
    # the minor axis steps after each pixel whose error term is negative
    minor = np.zeros(n, np.int64)
    err, m = dx - 2 * dy, 0
    if dy:
        for i in range(1, n):
            if err < 0:
                m += 1
                err += 2 * dx
            err -= 2 * dy
            minor[i] = m
    if steep:
        xs, ys = x + minor, y + sy * k
    else:
        xs, ys = x + k, y + sy * minor
    img[ys, xs] = color


def line_fixed(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int],
               color) -> None:
    """OpenCV's ``Line2``: the 8-connected segment between points of 16
    fractional bits, clipped to the image in that fixed point, walked
    along its major axis from its lower end (rounded on the minor axis
    by a truncated fixed-point slope), its upper end drawn rounded."""
    h, w = img.shape[:2]
    inside, (x1, y1), (x2, y2) = clip_line((w << XY_SHIFT, h << XY_SHIFT),
                                           p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    half = XY_ONE >> 1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dx, dy = x2, y2, x1, y1, -dx, -dy
        step = _tdiv(dy << XY_SHIFT, dx | 1)
        n = ((x2 - x1) >> XY_SHIFT) + 1
        k = np.arange(max(n, 0), dtype=np.int64)
        xs = ((x1 + half) >> XY_SHIFT) + k
        ys = (y1 + half + step * k) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx, dy = x2, y2, x1, y1, -dx, -dy
        step = _tdiv(dx << XY_SHIFT, abs(dy) | 1)
        n = ((y2 - y1) >> XY_SHIFT) + 1
        k = np.arange(max(n, 0), dtype=np.int64)
        ys = ((y1 + half) >> XY_SHIFT) + k
        xs = (x1 + half + step * k) >> XY_SHIFT
    xs = np.append(xs, (x2 + half) >> XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def fill_convex_poly(img: np.ndarray, pts: Sequence[Tuple[int, int]],
                     color, shift: int = 0) -> None:
    """``cv.fillConvexPoly(img, pts, color, cv.LINE_8, shift)``: the
    outline (``line`` of the truncated ends without a shift, else
    ``line_fixed``), then each row's span between the two edges walked
    down from the topmost vertex, their x stepped by rounded fixed-point
    slopes."""
    n = len(pts)
    if n == 0:
        return
    h, w = img.shape[:2]
    up = XY_SHIFT - shift
    delta = (1 << shift) >> 1
    half = XY_ONE >> 1
    p0 = (pts[-1][0] << up, pts[-1][1] << up)
    for x, y in pts:
        p = (x << up, y << up)
        if shift == 0:
            line(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                 (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            line_fixed(img, p0, p, color)
        p0 = p
    ys = [p[1] for p in pts]
    imin = ys.index(min(ys))
    xmin = (min(p[0] for p in pts) + delta) >> shift
    xmax = (max(p[0] for p in pts) + delta) >> shift
    ymin = (min(ys) + delta) >> shift
    ymax = (max(ys) + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    left = n                 # the C code's ``edges`` countdown
    y = ymin
    while True:
        for e in edges:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while True:
                    left -= 1
                    if left < 0:
                        break
                    ty = (pts[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = pts[idx0][0] << up, pts[idx][0] << up
                        e[:] = [idx, di, xs,
                                _tdiv((xe - xs) * 2 + (ty - y),
                                      2 * (ty - y)), ty]
                        break
                    idx0 = idx
                    idx = (idx + di) % n
        if left < 0:
            break
        if y >= 0:
            lo, hi = sorted((edges[0][2], edges[1][2]))
            x1, x2 = (lo + half) >> XY_SHIFT, (hi + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edges[0][2] += edges[0][3]
        edges[1][2] += edges[1][3]
        y += 1
        if y > ymax:
            break


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int,
                color) -> None:
    """``cv.circle(img, center, radius, color, -1)`` (LINE_8, no shift):
    OpenCV's ``Circle`` of integer midpoint steps, each step filling the
    four rows it reaches, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for row, half_w in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                            (cy + dx, dy)):
            x1, x2 = max(cx - half_w, 0), min(cx + half_w, w - 1)
            if 0 <= row < h and x1 <= x2:
                img[row, x1:x2 + 1] = color
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def thick_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
               color, thickness: int, caps: int = 3) -> None:
    """OpenCV 5's ``ThickLine`` of integer ends (LINE_8, no shift): at
    thickness 1 ``line``; else the ends first clipped to the image grown
    by ``thickness`` on each side, then the quad of half-width
    ``thickness / 2`` about the segment (``fill_convex_poly`` at 16
    fractional bits) and round caps (``fill_circle``) at the ends that
    ``caps`` names (bit 0: ``p0``, bit 1: ``p1``)."""
    if thickness <= 1:
        line(img, p0, p1, color)
        return
    h, w = img.shape[:2]
    m = thickness
    inside, p0, p1 = clip_line((w + 2 * m, h + 2 * m), (p0[0] + m, p0[1] + m),
                               (p1[0] + m, p1[1] + m))
    if not inside:
        return
    p0 = ((p0[0] - m) << XY_SHIFT, (p0[1] - m) << XY_SHIFT)
    p1 = ((p1[0] - m) << XY_SHIFT, (p1[1] - m) << XY_SHIFT)
    half = XY_ONE >> 1
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))
        fill_convex_poly(img, [(p0[0] + ex, p0[1] + ey),
                               (p0[0] - ex, p0[1] - ey),
                               (p1[0] - ex, p1[1] - ey),
                               (p1[0] + ex, p1[1] + ey)], color, XY_SHIFT)
    radius = (thickness + half) >> XY_SHIFT
    for bit, p in ((1, p0), (2, p1)):
        if caps & bit:
            fill_circle(img, ((p[0] + half) >> XY_SHIFT,
                              (p[1] + half) >> XY_SHIFT), radius, color)


def rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int],
              color, thickness: int = 1) -> None:
    """``cv.rectangle(img, pt1, pt2, color, thickness)`` (LINE_8, no
    shift): OpenCV's closed ``PolyLine`` of the four corners (``thick_line``
    from the last corner round, each segment capped at its end), or for a
    negative thickness the filled convex polygon."""
    (x1, y1), (x2, y2) = pt1, pt2
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness < 0:
        fill_convex_poly(img, corners, color)
        return
    p0 = corners[-1]
    for p in corners:
        thick_line(img, p0, p, color, thickness, caps=2)
        p0 = p


def put_text(img: np.ndarray, text: str, org: Tuple[int, int],
             font_scale: float, color, thickness: int = 1) -> None:
    """``cv.putText(img, text, org, cv.FONT_HERSHEY_PLAIN, font_scale,
    color, thickness, cv.LINE_8)`` as cv2 5.0 draws it: each character's
    coverage mask (``torchfcn.data.hershey``, recorded at the sizes it
    lists) blended into the image in turn, ``round((pixel * (255 - a) +
    color * a) / 255)`` per channel, the pen moving on by the character's
    advance.  Control characters draw as '?', as in cv2; so do characters
    beyond ASCII, which cv2 draws from its Unicode font (ROADMAP Queue 3
    item 9)."""
    from torchfcn.data import hershey
    table = hershey.glyphs(font_scale, thickness)
    h, w = img.shape[:2]
    col = np.asarray(color, np.int64)
    x, y = org
    for ch in text:
        code = ord(ch) if 32 <= ord(ch) < 127 else ord("?")
        adv, x0, y0, mask = table[code - 32]
        gx, gy = x + x0, y + y0
        r0, r1 = max(gy, 0), min(gy + mask.shape[0], h)
        c0, c1 = max(gx, 0), min(gx + mask.shape[1], w)
        if r0 < r1 and c0 < c1:
            a = mask[r0 - gy:r1 - gy, c0 - gx:c1 - gx].astype(np.int64)
            if img.ndim == 3:
                a = a[..., None]
            v = img[r0:r1, c0:c1].astype(np.int64)
            img[r0:r1, c0:c1] = (2 * (v * (255 - a) + col * a) + 255) // 510
        x += adv


def add_weighted_u8(a: np.ndarray, alpha: float, b: np.ndarray,
                    beta: float) -> np.ndarray:
    """``cv.addWeighted(a, alpha, b, beta, 0)`` of uint8 images: in float32
    as OpenCV's vector loop computes it, ``fma(a, alpha, b * beta)``,
    rounded half to even and saturated."""
    inner = b.astype(np.float32) * np.float32(beta)
    out = fma_f32(a.astype(np.float32), np.float32(alpha), inner)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _jet_lut() -> np.ndarray:
    """(256, 3) uint8 BGR of ``cv.COLORMAP_JET``: each channel a ramp of 4
    levels a step between half-integers, rounded half to even (blue rises
    from 127.5 at 0, is 255 from 32 to 95 and falls to 0 at 160; green and
    red follow 64 and 128 steps later), except where OpenCV's float32
    interpolation of its table rounds a half down: blue 1.5 at 159."""
    i = np.arange(256)
    ramps = [np.minimum(4 * i + a + 0.5, b + 0.5 - 4 * i)
             for a, b in ((127, 637), (-129, 891), (-383, 1147))]
    lut = np.clip(np.rint(np.stack(ramps, axis=-1)), 0, 255).astype(np.uint8)
    lut[159, 0] = 1
    return lut


JET_LUT = _jet_lut()


def apply_colormap_jet(img: np.ndarray) -> np.ndarray:
    """``cv.applyColorMap(img, cv.COLORMAP_JET)`` of a uint8 image of 1
    channel: (..., 3) BGR."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"applyColorMap takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 3:       # cv2 maps the gray image
        from torchfcn.data.manifest import bgr2gray_u8
        img = bgr2gray_u8(img)
    return JET_LUT[img.reshape(img.shape[:2])]
