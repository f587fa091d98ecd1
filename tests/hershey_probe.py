"""Read back how cv2 5.0 draws ``FONT_HERSHEY_PLAIN`` and write it as
``torchfcn/data/hershey.py``.

cv2 5.0 no longer strokes the Hershey polylines for this font: its
``putText`` draws each glyph as an anti-aliased coverage mask (even with
``LINE_8``) and blends it into the image, ``round((pixel * (255 - a) +
color * a) / 255)`` per channel, glyph after glyph, the pen moving on by a
whole number of pixels per glyph.  Neither the outlines nor the rasterizer
are in the repo, so this script records what they give at the sizes in
``SIZES`` (the overlay draws at scale 2, thickness 2):

1. each of the 95 printable ASCII characters drawn alone, in white on
   black, at a known origin: its coverage mask is the image, its offset
   the mask's bounding box against the origin;
2. its advance: the shift at which a "|" drawn after it, blended over it,
   gives ``putText``'s raster of the pair;
3. the check: ``torchfcn.data.raster.put_text`` against ``cv.putText`` on
   every pair of characters (blends where glyphs overlap included), on
   the printable line at clipped origins, and on random strings in random
   colours over random backgrounds; control characters draw as '?' in
   both.

Run from the repository root with cv2 installed: ``python
tests/hershey_probe.py`` (about a minute).  It rewrites
``torchfcn/data/hershey.py`` and prints what it checked.  The name keeps
pytest from collecting it.
"""

from __future__ import annotations

import base64
import itertools
import os
import sys
import zlib

import cv2 as cv
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = ((2.0, 2),)               # (fontScale, thickness)
ORIGIN = (40, 80)
CANVAS = (160, 200)               # rows, columns
OUT = os.path.join(ROOT, "torchfcn", "data", "hershey.py")
PRINTABLE = [chr(c) for c in range(32, 127)]


def draw(text: str, scale: float, thickness: int, origin=ORIGIN,
         shape=CANVAS) -> np.ndarray:
    img = np.zeros(shape, np.uint8)
    cv.putText(img, text, origin, cv.FONT_HERSHEY_PLAIN, scale, 255,
               thickness, cv.LINE_8)
    return img


def blend_over(under: np.ndarray, over: np.ndarray) -> np.ndarray:
    """White coverage ``over`` blended onto ``under`` (uint8 masks)."""
    u, a = under.astype(np.int64), over.astype(np.int64)
    return ((2 * (u * (255 - a) + 255 * a) + 255) // 510).astype(np.uint8)


def glyph(ch: str, scale: float, thickness: int) -> tuple:
    """(x0, y0, mask) of a character: its coverage's bounding box from the
    origin and the coverage inside it."""
    img = draw(ch, scale, thickness)
    ys, xs = np.nonzero(img)
    if not len(xs):
        return 0, 0, np.zeros((0, 0), np.uint8)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    if min(y0, x0) == 0 or y1 == img.shape[0] or x1 == img.shape[1]:
        raise AssertionError(f"glyph {ch!r} touches the probe's canvas")
    return int(x0 - ORIGIN[0]), int(y0 - ORIGIN[1]), img[y0:y1, x0:x1]


def advance(ch: str, scale: float, thickness: int) -> int:
    alone = draw(ch, scale, thickness)
    bar = draw("|", scale, thickness)
    pair = draw(ch + "|", scale, thickness)
    hits = [s for s in range(0, 100)
            if np.array_equal(blend_over(alone, np.roll(bar, s, 1)), pair)]
    if len(hits) != 1:
        raise AssertionError(f"glyph {ch!r}: advances {hits} fit")
    return hits[0]


def write_module(tables: dict) -> None:
    out = [
        '"""OpenCV\'s ``FONT_HERSHEY_PLAIN`` as cv2 5.0 draws it, for',
        '``torchfcn.data.raster.put_text``.',
        '',
        'Generated by ``tests/hershey_probe.py`` from ``cv.putText``; do not',
        'edit.  cv2 5.0 draws this font as anti-aliased coverage masks, not',
        'as Hershey strokes: ``FONTS[(scale, thickness)]`` holds, for each',
        'of the 95 printable ASCII characters (32 to 126), ``(advance, x0,',
        'y0, w, h)`` in pixels, the mask\'s top-left corner taken from the',
        'pen at the text origin\'s baseline, and the masks themselves, row',
        'major and one after another, zlib-compressed and base64-encoded.',
        '"""',
        '',
        'from __future__ import annotations',
        '',
        'import base64',
        'import functools',
        'import zlib',
        'from typing import List, Tuple',
        '',
        'import numpy as np',
        '',
        'FONTS = {',
    ]
    for (scale, thickness), (metrics, blob) in tables.items():
        out.append(f"    ({scale!r}, {thickness}): (")
        out.append("        (")
        for ch, m in zip(PRINTABLE, metrics):
            out.append(f"            {m},  # {ch!r}")
        out.append("        ),")
        text = base64.b64encode(blob).decode()
        out.append("        (")
        for i in range(0, len(text), 68):
            out.append(f'            "{text[i:i + 68]}"')
        out.append("        ),")
        out.append("    ),")
    out += [
        '}',
        '',
        '',
        '@functools.lru_cache(maxsize=None)',
        'def glyphs(scale: float, thickness: int',
        '           ) -> List[Tuple[int, int, int, np.ndarray]]:',
        '    """(advance, x0, y0, coverage uint8 (h, w)) of each printable',
        '    character at a recorded size; other sizes raise ValueError."""',
        '    key = (float(scale), int(thickness))',
        '    if key not in FONTS:',
        '        raise ValueError(f"FONT_HERSHEY_PLAIN is recorded at (scale, "',
        '                         f"thickness) {sorted(FONTS)}, not {key}")',
        '    metrics, chunks = FONTS[key]',
        '    data = zlib.decompress(base64.b64decode("".join(chunks)))',
        '    out, pos = [], 0',
        '    for adv, x0, y0, w, h in metrics:',
        '        mask = np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w)',
        '        out.append((adv, x0, y0, mask))',
        '        pos += w * h',
        '    return out',
    ]
    with open(OUT, "w") as f:
        f.write("\n".join(out) + "\n")


def check(scale: float, thickness: int) -> dict:
    """Differing values of raster.put_text against cv.putText."""
    from torchfcn.data import raster
    bad = {}

    def compare(key, text, origin, shape, color=255, bg=0):
        want = np.full(shape, bg, np.uint8)
        cv.putText(want, text, origin, cv.FONT_HERSHEY_PLAIN, scale, color,
                   thickness, cv.LINE_8)
        got = np.full(shape, bg, np.uint8)
        raster.put_text(got, text, origin, scale, color, thickness)
        n = int((want != got).sum())
        if n:
            bad[key] = bad.get(key, 0) + n

    for a, b in itertools.product(PRINTABLE, PRINTABLE):
        compare("pairs", a + b, (10, 40), (60, 80))
    line = "".join(PRINTABLE)
    for origin in ((-7, 40), (-300, 12), (5, 70), (1500, 30), (3, 3)):
        compare(f"line at {origin}", line, origin, (60, 1600))
    compare("control characters", "a\tb\x01\x7f?", (5, 40), (60, 200))
    rng = np.random.default_rng(0)
    for i in range(200):
        text = "".join(rng.choice(PRINTABLE, int(rng.integers(1, 30))))
        shape = (int(rng.integers(10, 80)), int(rng.integers(10, 300)), 3)
        bg = rng.integers(0, 256, shape, dtype=np.uint8)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        origin = (int(rng.integers(-100, 300)), int(rng.integers(-10, 100)))
        want = bg.copy()
        cv.putText(want, text, origin, cv.FONT_HERSHEY_PLAIN, scale, color,
                   thickness, cv.LINE_8)
        got = bg.copy()
        raster.put_text(got, text, origin, scale, color, thickness)
        n = int((want != got).sum())
        if n:
            bad["random"] = bad.get("random", 0) + n
    return bad


def main() -> None:
    tables = {}
    for scale, thickness in SIZES:
        metrics, masks = [], []
        for ch in PRINTABLE:
            x0, y0, mask = glyph(ch, scale, thickness)
            adv = advance(ch, scale, thickness)
            metrics.append((adv, x0, y0, mask.shape[1], mask.shape[0]))
            masks.append(mask.tobytes())
        tables[(scale, thickness)] = (tuple(metrics),
                                      zlib.compress(b"".join(masks), 9))
    write_module(tables)
    import importlib
    from torchfcn.data import hershey
    importlib.reload(hershey)
    for scale, thickness in SIZES:
        bad = check(scale, thickness)
        print(f"scale {scale}, thickness {thickness}: differing values "
              f"against cv.putText: {bad or 'none'}")
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
