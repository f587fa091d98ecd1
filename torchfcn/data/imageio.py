"""Image files of the port without ``cv2`` (the card's host has none):
8-bit PNG in numpy and ``zlib``, and baseline JPEG (``torchfcn.data.jpeg``).

``imread(path)`` is ``cv.imread(path)`` (``IMREAD_COLOR``), a (H, W, 3) uint8
BGR array, chosen by the file's first bytes: a baseline JPEG
(``jpeg.decode``, bit-equal to cv2's libjpeg-turbo), or an 8-bit,
non-interlaced PNG of colour type 0 (gray, replicated to three channels), 2
(RGB) or 6 (RGBA, alpha dropped), rows of any of the five PNG filters
undone.  Any other file (another format, a progressive JPEG, another PNG
bit depth, colour type or interlace, or a damaged file) raises
``ValueError`` naming the file; ``imread_or_none`` returns None there, as
``cv.imread`` does.

``imwrite(path, img)`` writes a (H, W) gray, (H, W, 3) BGR or (H, W, 4)
BGRA uint8 array as such a PNG, every row with one filter (0-4).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from torchfcn.data import jpeg

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, w: int, bpp: int, path: str
              ) -> np.ndarray:
    stride = w * bpp
    if len(data) != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {len(data)} bytes, "
                         f"not {h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):
            # left neighbours depend on the row's own output: per pixel
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                left = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                up = prev[x:x + bpp]
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + up) >> 1
                else:
                    upleft = (prev[x - bpp:x] if x
                              else np.zeros(bpp, np.int32))
                    pred = _paeth(left, up, upleft)
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def imread(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR pixels of a baseline JPEG or an 8-bit PNG, as
    ``cv.imread``."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(jpeg.SOI):
        return jpeg.decode(raw, path)
    if not raw.startswith(SIGNATURE):
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
    pos, header, idat = len(SIGNATURE), None, []
    while True:
        if pos + 8 > len(raw):
            raise ValueError(f"{path}: PNG ends before its IEND chunk")
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + length]
        crc = raw[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or \
                zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: damaged PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray, RGB or RGBA PNGs are "
            f"read, this one has bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}")
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data does not inflate: {e}")
    c = _CHANNELS[ctype]
    pix = _unfilter(data, h, w, c, path).reshape(h, w, c)
    if c == 1:
        return np.repeat(pix, 3, axis=2)
    return np.ascontiguousarray(pix[..., 2::-1])      # RGB(A) -> BGR


def imread_or_none(path: str) -> Optional[np.ndarray]:
    """``imread(path)``, or None where the file is missing or not an image
    that ``imread`` reads (``cv.imread``'s None)."""
    try:
        return imread(path)
    except (OSError, ValueError):
        return None


def _filter_rows(pix: np.ndarray, bpp: int, kind: int) -> bytes:
    h, stride = pix.shape
    cur = pix.astype(np.int32)
    prev = np.vstack([np.zeros((1, stride), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), cur[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int32), prev[:, :-bpp]])
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1,
            4: _paeth(left, prev, upleft)}[kind]
    rows = ((cur - pred) & 0xFF).astype(np.uint8)
    return np.hstack([np.full((h, 1), kind, np.uint8), rows]).tobytes()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def imwrite(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """Write a (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8 array as
    an 8-bit PNG whose rows all take ``filter_type`` (0-4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (3, 4)):
        raise ValueError(f"{path}: imwrite takes (H, W), (H, W, 3) or "
                         f"(H, W, 4) uint8, got {img.shape} {img.dtype}")
    if filter_type not in range(5):
        raise ValueError(f"{path}: PNG filter type {filter_type} not in 0-4")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    pix = img if c == 1 else np.concatenate(
        [img[..., 2::-1], img[..., 3:]], axis=2)          # BGR(A) -> RGB(A)
    ctype = {1: 0, 3: 2, 4: 6}[c]
    data = _filter_rows(pix.reshape(h, w * c), c, filter_type)
    png = (SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(data, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
