"""The host compositor of the port (``tpufcn/data/compositor.py``): copy-paste
scenes and the photometric chain on the host, in numpy, without ``cv2`` (the
card's host has none).

* :class:`Compositor`: masked object crops pasted onto a background at
  random places that overlap little (scaled IoU at most ``iou_thresh``,
  ``max_trials`` candidates drawn in bulk), each crop flipped and rescaled
  at random; returns the scene, its instance mask, rects and labels;
* :func:`random_augmentation`: random flip, zoom-crop around a single box,
  photometric jitter (and the reference's gated-off rotation);
* :func:`photometric`: blur (Gaussian, box or median), sharpen, additive
  and multiplicative jitter, partial grayscale;
* :func:`fcn_crop_sample`: flip and a scale-jittered crop around the
  mask's largest contour, resized, the mask to the class label.

Every ``np.random.Generator`` call is the JAX package's, in its order, so
one seed gives the same draws and leaves the generator in the same state.
The pixel work is ``torchfcn.data.raster``'s, each function equal to the
cv2 call it replaces but for the cubic upscale of
``resize_image_and_rects`` (within 1 of cv2's IPP build, at about 1e-5 of
the values).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from torchfcn.data import raster
from torchfcn.data.imageio import imread_or_none
from torchfcn.data.manifest import MaskSample, bgr2gray_u8
from torchfcn.data.raster import flip, flip_image_with_rects


def _scaled_iou_vec(b, cx, cy, w, h):
    """The reference's scaled IoU (``JaccardCoeff.iou``) of box ``b``
    against candidate boxes (cx, cy, w, h) over vectors cx / cy."""
    ix = np.maximum(b[0], cx)
    iy = np.maximum(b[1], cy)
    iw = np.minimum(b[0] + b[2], cx + w) - ix
    ih = np.minimum(b[1] + b[3], cy + h) - iy
    ux = np.minimum(b[0], cx)
    uy = np.minimum(b[1], cy)
    uw = np.maximum(b[0] + b[2], cx + w) - ux
    uh = np.maximum(b[1] + b[3], cy + h) - uy
    inter = iw * ih
    score = np.where((iw < 0) | (ih < 0) | (inter == 0),
                     0.0, inter / (uw * uh))
    return score / (float(b[2] * b[3]) / float(w * h))


def photometric(image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Blur -> sharpen -> add -> multiply -> grayscale, with the reference's
    parameter ranges, in float32; the result clipped and truncated to
    uint8."""
    img = image.astype(np.float32)

    blur_kind = rng.integers(0, 3)
    if blur_kind == 0:
        sigma = float(rng.uniform(0.0, 3.0))
        if sigma > 1e-3:
            img = raster.gaussian_blur_f32(img, sigma)
    elif blur_kind == 1:
        k = int(rng.integers(2, 8))
        img = raster.box_blur_f32(img, k)
    else:
        k = int(rng.integers(1, 4)) * 2 + 1  # odd in 3..7
        img = raster.median_blur_u8(img.astype(np.uint8), k).astype(
            np.float32)

    # sharpen: blend identity with a sharpening kernel (imgaug Sharpen)
    alpha = float(rng.uniform(0.0, 1.0))
    lightness = float(rng.uniform(0.75, 1.5))
    kern = np.array([[-1, -1, -1],
                     [-1, 8 + lightness, -1],
                     [-1, -1, -1]], np.float32)
    sharp = raster.filter2d_3x3_f32(img, kern)
    img = (1 - alpha) * img + alpha * sharp

    # Add (-2, 21), per_channel p=0.5
    if rng.random() < 0.5:
        img += rng.uniform(-2, 21, size=(1, 1, img.shape[2]))
    else:
        img += float(rng.uniform(-2, 21))

    # Multiply (0.75, 1.25), per_channel p=0.5
    if rng.random() < 0.5:
        img *= rng.uniform(0.75, 1.25, size=(1, 1, img.shape[2]))
    else:
        img *= float(rng.uniform(0.75, 1.25))

    # Grayscale alpha in (0, 0.5)
    ga = float(rng.uniform(0.0, 0.5))
    if ga > 1e-3:
        gray = bgr2gray_u8(np.clip(img, 0, 255).astype(np.uint8)).astype(
            np.float32)
        img = (1 - ga) * img + ga * gray[..., None]

    return np.clip(img, 0, 255).astype(np.uint8)


def zoom_crop(image: np.ndarray, rect, rng: np.random.Generator,
              label_map: Optional[np.ndarray] = None):
    """The reference's crop_image_dimension and enlarge-factor draw
    (argumentation_engine.py:155-236): a random crop that holds the box.
    ``label_map`` is cropped with the same window (the JAX package's fix of
    the reference, which crops only the image)."""
    x, y, w, h = [int(v) for v in rect]
    if w <= 0 or h <= 0:
        return image, list(rect), label_map
    scale_x = int(math.floor(image.shape[1] / float(w)))
    scale_y = int(math.floor(image.shape[0] / float(h)))
    e1 = float(rng.uniform(1.0, max(scale_x, 1.0)))
    e2 = float(rng.uniform(1.0, max(scale_y, 1.0)))
    widths = (int(w * e1), w * e2)
    heights = (int(h * e1), h * e2)

    cx0 = x + w // 2 - widths[0]
    cy0 = y + h // 2 - heights[0]
    cw = widths[1] + widths[0]
    ch = heights[1] + heights[0]

    cx, cy = x + w / 2.0, y + h / 2.0
    sx = int(rng.integers(0, max(int(cw / 2), 1)))
    sy = int(rng.integers(0, max(int(ch / 2), 1)))
    cx = cx + sx if rng.integers(0, 2) else cx - sx
    cy = cy + sy if rng.integers(0, 2) else cy - sy

    nx = int(cx - cw / 2)
    ny = int(cy - ch / 2)
    nw, nh = int(cw), int(ch)
    if nx > cx0:
        nx = cx0
        nw -= abs(nx - cx0)
    if ny > cy0:
        ny = cy0
        nh -= abs(ny - cy0)
    if nx + nw < cx0 + cw:
        nx += (cx0 + cw) - (nx + nw)
    if ny + nh < cy0 + ch:
        ny += (cy0 + ch) - (ny + nh)

    nx = max(int(nx), 0)
    ny = max(int(ny), 0)
    roi = image[ny:ny + int(nh), nx:nx + int(nw)]
    if roi.size == 0:
        return image, list(rect), label_map
    if label_map is not None:
        label_map = label_map[ny:ny + int(nh), nx:nx + int(nw)].copy()
    return roi.copy(), [int(x - nx), int(y - ny), w, h], label_map


def rotate_image_with_rects(image: np.ndarray, rects,
                            rng: np.random.Generator,
                            max_angle: int = 5,
                            label_map: Optional[np.ndarray] = None):
    """The reference's ``rotate_image_with_rect`` (argumentation_engine.py:
    327-355, gated off there): a bilinear rotation about the centre by a
    random integer angle in [-max_angle, max_angle], each rect replaced by
    the bounding box of its four rotated corners (truncated); a given
    ``label_map`` rotated nearest-neighbour."""
    h, w = image.shape[:2]
    center = (w / 2, h / 2)
    angle = float(rng.integers(-max_angle, max_angle + 1))
    m = raster.get_rotation_matrix_2d(center, angle, 1)
    im_rot = raster.warp_affine_u8(image, m, (w, h))
    out = []
    for rect in rects:
        x, y, rw, rh = [float(v) for v in rect]
        xs = (x, x + rw, x, x + rw)
        ys = (y, y, y + rh, y + rh)
        px = [int(xc * m[0, 0] + yc * m[0, 1] + m[0, 2])
              for xc, yc in zip(xs, ys)]
        py = [int(xc * m[1, 0] + yc * m[1, 1] + m[1, 2])
              for xc, yc in zip(xs, ys)]
        out.append([min(px), min(py),
                    max(px) - min(px), max(py) - min(py)])
    if label_map is not None:
        label_map = raster.warp_affine_u8(label_map, m, (w, h), nearest=True)
    return im_rot, out, label_map


def random_augmentation(image: np.ndarray, rects,
                        rng: np.random.Generator,
                        label_map: Optional[np.ndarray] = None,
                        enable_zoom: bool = True,
                        enable_photometric: bool = True,
                        rotate: bool = False):
    """Flip + zoom-crop (single box, as the reference) + photometric (+ the
    reference's gated-off rotation when ``rotate=True``, after photometric
    as in the reference chain :176-183)."""
    flip_code = int(rng.integers(-1, 3))    # {-1, 0, 1, 2}; 2 = no flip
    if -2 < flip_code < 2:
        image, rects = flip_image_with_rects(image, rects, flip_code)
        if label_map is not None:
            label_map = flip(label_map, flip_code)
    else:
        rects = [list(r) for r in rects]

    if enable_zoom and len(rects) == 1:
        image, rect, label_map = zoom_crop(image, rects[0], rng, label_map)
        rects = [rect]

    if enable_photometric:
        image = photometric(image, rng)
    if rotate:
        image, rects, label_map = rotate_image_with_rects(
            image, rects, rng, label_map=label_map)
    return image, rects, label_map


def resize_image_and_rects(image: np.ndarray, rects,
                           size_wh: Tuple[int, int]):
    """The reference's resize_image_and_labels (:114-138), its int floors
    included: the image by ``raster.resize_cubic_u8`` (cv2's INTER_CUBIC)."""
    img = raster.resize_cubic_u8(image, size_wh)
    rx = np.float32(image.shape[1]) / np.float32(size_wh[0])
    ry = np.float32(image.shape[0]) / np.float32(size_wh[1])
    out = []
    for rect in rects:
        x, y, w, h = [np.float32(v) for v in rect]
        xt, yt = x / rx, y / ry
        xb, yb = (x + w) / rx, (y + h) / ry
        out.append([int(xt), int(yt), int(xb - xt), int(yb - yt)])
    return img, out


@dataclasses.dataclass
class ComposedScene:
    image: np.ndarray        # (H, W, 3) uint8 BGR
    mask: np.ndarray         # (H, W) uint8 instance labels (label+1)
    rects: np.ndarray        # (M, 4) int
    labels: np.ndarray       # (M,) int


class Compositor:
    """Copy-paste scene builder over a MaskSample dataset.  ``imread(path)``
    returns a BGR (or gray) uint8 image, or None to skip the sample
    (default ``imageio.imread_or_none``: PNG and baseline JPEG, as
    ``cv.imread``); decoded images are kept in a cache of
    ``cache_images``."""

    def __init__(self, samples: Sequence[MaskSample],
                 iou_thresh: float = 0.05,
                 max_trials: int = 100,
                 scale_range: Tuple[float, float] = (1.0, 2.2),
                 imread=imread_or_none,
                 cache_images: int = 256):
        if not samples:
            raise ValueError("empty compositor dataset")
        self.samples = list(samples)
        self.iou_thresh = iou_thresh
        self.max_trials = max_trials
        self.scale_range = scale_range
        if cache_images:
            # decode once: the reference reads every paste's files again
            # (argumentation_engine.py:671-672)
            self.imread = functools.lru_cache(maxsize=cache_images)(
                lambda p: imread(p))
        else:
            self.imread = imread

    def compose(self, num_proposals: int, background: np.ndarray,
                rng: np.random.Generator,
                base_mask: Optional[np.ndarray] = None,
                base_rect=None) -> ComposedScene:
        im_y, im_x = background.shape[:2]
        img_out = background.copy()
        mask_out = (base_mask.copy() if base_mask is not None
                    else np.zeros((im_y, im_x), np.uint8))
        # `placed` drives overlap rejection (and includes the caller's
        # base_rect, as the reference seeds flag_position with mrect);
        # `rects`/`labels` report only the pasted objects, kept aligned.
        placed: List = [list(base_rect)] if base_rect is not None else []
        rects: List = []
        labels: List = []

        for _ in range(num_proposals):
            s = self.samples[int(rng.integers(0, len(self.samples)))]
            image = self.imread(s.image_path)
            mask = self.imread(s.mask_path)
            if image is None or mask is None:
                continue
            if mask.ndim == 3:
                mask = bgr2gray_u8(mask)
            mask = (mask > 0).astype(np.uint8) * 255
            rect = [int(v) for v in s.rect]

            flip_code = int(rng.integers(-1, 3))
            if -2 < flip_code < 2:
                image, fr = flip_image_with_rects(image, [rect], flip_code)
                mask = flip(mask, flip_code)
                rect = fr[0]
            x, y, w, h = rect
            x, y = max(x, 0), max(y, 0)
            w = min(w, image.shape[1] - x)
            h = min(h, image.shape[0] - y)
            if w <= 1 or h <= 1:
                continue
            roi = image[y:y + h, x:x + w]
            msk = mask[y:y + h, x:x + w]

            if rng.integers(0, 2):
                scale = float(rng.uniform(*self.scale_range))
                w = int(w * scale)
                h = int(h * scale)
                if w < 1 or h < 1 or w > im_x or h > im_y:
                    w = min(max(w, 1), im_x)
                    h = min(max(h, 1), im_y)
                roi = raster.resize_linear_u8(roi, (w, h))
                msk = raster.resize_nearest_u8(msk, (w, h))

            nrect = self._place(w, h, im_x, im_y, placed, rng)
            if nrect is None:
                continue
            cx, cy = nrect[0], nrect[1]
            ph = min(h, im_y - cy)
            pw = min(w, im_x - cx)
            sel = msk[:ph, :pw] > 0
            img_out[cy:cy + ph, cx:cx + pw][sel] = roi[:ph, :pw][sel]
            # instance mask stores label+1 (reference :728)
            mask_out[cy:cy + ph, cx:cx + pw][sel] = s.label + 1
            placed.append(nrect)
            rects.append(nrect)
            labels.append(s.label)

        return ComposedScene(
            image=img_out, mask=mask_out,
            rects=np.asarray(rects, np.int32).reshape(-1, 4),
            labels=np.asarray(labels, np.int32))

    def _place(self, w, h, im_x, im_y, placed, rng):
        """Rejection sampling with all ``max_trials`` candidates drawn in two
        bulk calls and checked against ``placed`` at once: the first
        candidate that passes wins, None when none does."""
        cx = rng.integers(0, im_x, size=self.max_trials)
        cy = rng.integers(0, im_y, size=self.max_trials)
        cx = np.maximum(np.where(cx + w > im_x - 1, cx - (cx + w - im_x), cx),
                        0)
        cy = np.maximum(np.where(cy + h > im_y - 1, cy - (cy + h - im_y), cy),
                        0)
        if not placed:
            return [int(cx[0]), int(cy[0]), w, h]
        p = np.asarray(placed, np.float64)            # (P, 4)
        ok = np.ones(self.max_trials, bool)
        for b in p:                                   # P is 1-4 rects
            iou = _scaled_iou_vec(b, cx, cy, w, h)
            ok &= iou <= self.iou_thresh
        idx = int(np.argmax(ok))
        if not ok[idx]:
            return None
        return [int(cx[idx]), int(cy[idx]), w, h]


def fcn_crop_sample(image: np.ndarray, mask: np.ndarray, label: int,
                    size_wh: Tuple[int, int], rng: np.random.Generator,
                    scales=(3.0, 3.5, 4.0)):
    """ArgumentationEngineFCN.process2: flip, a scale-jittered crop around
    the bounding box of the mask's largest contour, resized (the mask
    nearest-neighbour) -> (rgb, mask of ``label`` on 0)."""
    flip_code = int(rng.integers(-1, 2))
    image = flip(image, flip_code)
    mask = flip(mask, flip_code)
    if mask.ndim == 3:
        mask = bgr2gray_u8(mask)

    box = raster.largest_contour_rect(mask, area_zero=True)
    if box is None:
        return (raster.resize_linear_u8(image, size_wh),
                raster.resize_nearest_u8(mask, size_wh))
    x, y, w, h = box

    s = float(scales[int(rng.integers(0, len(scales)))])
    cx, cy = x + w / 2.0, y + h / 2.0
    nw, nh = int(s * w), int(s * h)
    nx = max(int(cx - nw / 2.0), 0)
    ny = max(int(cy - nh / 2.0), 0)
    r = int(rng.integers(-min(w // 2, h // 2) or -1,
                         (min(w // 2, h // 2) or 1) + 1))
    nx, ny = max(nx + r, 0), max(ny + r, 0)
    nw = min(nw, image.shape[1] - nx)
    nh = min(nh, image.shape[0] - ny)
    if nw < 2 or nh < 2:
        nx, ny, nw, nh = 0, 0, image.shape[1], image.shape[0]

    rgb = raster.resize_linear_u8(image[ny:ny + nh, nx:nx + nw], size_wh)
    m = raster.resize_nearest_u8(mask[ny:ny + nh, nx:nx + nw], size_wh)
    m = np.where(m > 0, np.uint8(label), np.uint8(0))
    return rgb, m
