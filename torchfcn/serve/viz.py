"""Detection visualization on the host (``tpufcn/serve/viz.py``), without
cv2.

The reference's observability is cv.imshow windows with filled class-
coloured rectangles, green outlines and class labels, then an alpha blend.
tpufcn renders that overlay to an array with cv2; the card's host has no
cv2, so this module draws it in numpy through ``torchfcn.data.raster``'s
copies of cv2 5.0's rectangle, text, blend and colour map, pixel for pixel
(``tests/test_torch_viz.py`` holds each function against tpufcn's).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from torchfcn.data import raster

__all__ = ["class_colors", "draw_detections", "colorize_pmap",
           "feature_grid"]


def class_colors(n: int, seed: int = 0) -> List[Tuple[int, int, int]]:
    """Stable random per-class BGR colours (the reference assigns random
    colours per class)."""
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(n)]


def draw_detections(frame_bgr: np.ndarray,
                    detections: Sequence[Tuple[Sequence[float], int, float]],
                    names: Optional[Sequence[str]] = None,
                    alpha: float = 0.3,
                    seed: int = 0) -> np.ndarray:
    """Render (box, label, confidence) tuples like the reference overlay:
    per detection a filled box in its class colour (the colours drawn for
    the largest label present), a 4-pixel green border and the label with
    its confidence in blue at scale 2 above the box, then the frame
    blended over it at ``alpha``.

    detections: output of ``DetectionResult.to_lists()[i]``.
    Returns a new image; the input is untouched.
    """
    n_cls = max((l for _, l, _ in detections), default=0) + 1
    colors = class_colors(max(n_cls, 1), seed)
    canvas = frame_bgr.copy()
    for box, label, conf in detections:
        x1, y1, x2, y2 = [int(v) for v in box[:4]]
        raster.rectangle(canvas, (x1, y1), (x2, y2), colors[label], -1)
        raster.rectangle(canvas, (x1, y1), (x2, y2), (0, 255, 0), 4)
        text = (names[label] if names and label < len(names)
                else f"object_{label}")
        raster.put_text(canvas, f"{text} {conf:.2f}", (x1, max(y1 - 4, 12)),
                        2, (255, 0, 0), 2)
    return raster.add_weighted_u8(frame_bgr, alpha, canvas, 1.0 - alpha)


def colorize_pmap(pmap_u8: np.ndarray) -> np.ndarray:
    """JET colour map over a mono8 probability map (the reference's debug
    views)."""
    return raster.apply_colormap_jet(pmap_u8)


def feature_grid(features: np.ndarray, pad: int = 1) -> np.ndarray:
    """Tile a (H, W, C) activation tensor into a near-square uint8
    mosaic, the reference's ``vis_square`` feature-map debug view: pad
    each map, normalize to [0, 1], arrange ceil(sqrt(C))² tiles row-major.

    Accepts NHWC too (first image is shown).  Returns (GH, GW) uint8.
    """
    f = np.asarray(features, np.float32)
    if f.ndim == 4:
        f = f[0]
    if f.ndim != 3:
        raise ValueError(f"expected (H, W, C) features, got {f.shape}")
    f = np.moveaxis(f, -1, 0)                      # (C, H, W)
    lo, hi = f.min(), f.max()
    f = (f - lo) / (hi - lo) if hi > lo else np.zeros_like(f)
    n = int(np.ceil(np.sqrt(f.shape[0])))
    f = np.pad(f, ((0, n * n - f.shape[0]), (0, pad), (0, pad)),
               constant_values=1.0)                # white separators
    c, h, w = f.shape
    grid = (f.reshape(n, n, h, w)
             .transpose(0, 2, 1, 3)
             .reshape(n * h, n * w))
    return (grid * 255.0 + 0.5).astype(np.uint8)
