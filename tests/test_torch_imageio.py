"""The port's PNG frame files (``torchfcn/data/imageio.py``) against cv2:
the reader bit-equal to ``cv.imread`` on PNGs that cv2 wrote (gray, BGR
and BGRA, each of the five row filters and cv2's adaptive choice), cv2
reading the writer's files back exactly (every filter), and every other
file (a progressive JPEG among them; baseline JPEGs are read, see
``tests/test_torch_jpeg.py``) raising ``ValueError`` that names it."""

import os
import struct
import zlib

import cv2 as cv
import numpy as np
import pytest

from torchfcn.data.imageio import imread, imwrite

FILTERS = (cv.IMWRITE_PNG_FILTER_NONE, cv.IMWRITE_PNG_FILTER_SUB,
           cv.IMWRITE_PNG_FILTER_UP, cv.IMWRITE_PNG_FILTER_AVG,
           cv.IMWRITE_PNG_FILTER_PAETH, cv.IMWRITE_PNG_ALL_FILTERS)
SHAPES = ((17, 23), (17, 23, 3), (17, 23, 4), (48, 64, 3), (1, 1, 3))


def _image(shape, seed):
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    img[: shape[0] // 2, : shape[1] // 3] = 7          # a flat patch
    return img


def _row_filters(path):
    """The filter byte of every row of a PNG (IDAT inflated)."""
    raw = open(path, "rb").read()
    pos, idat, header = 8, [], None
    while pos < len(raw):
        n, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, _, ctype = header[:4]
    stride = w * {0: 1, 2: 3, 6: 4}[ctype] + 1
    data = zlib.decompress(b"".join(idat))
    return {data[y * stride] for y in range(h)}


@pytest.mark.parametrize("shape", SHAPES)
def test_reader_equals_cv2_imread(tmp_path, shape):
    seen = set()
    for i, flt in enumerate(FILTERS):
        img = _image(shape, i)
        path = str(tmp_path / "a.png")
        assert cv.imwrite(path, img, [cv.IMWRITE_PNG_FILTER, flt])
        got = imread(path)
        want = cv.imread(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        seen |= _row_filters(path)
    if shape[0] > 1:
        assert seen == {0, 1, 2, 3, 4}       # every filter was read


@pytest.mark.parametrize("shape", SHAPES)
def test_cv2_reads_the_writer_back(tmp_path, shape):
    for flt in range(5):
        img = _image(shape, 10 + flt)
        path = str(tmp_path / f"b{flt}.png")
        imwrite(path, img, flt)
        assert _row_filters(path) == {flt}
        np.testing.assert_array_equal(cv.imread(path, cv.IMREAD_UNCHANGED),
                                      img)
        np.testing.assert_array_equal(imread(path), cv.imread(path))


def test_other_files_raise_naming_the_file(tmp_path):
    img = _image((9, 11, 3), 0)
    cases = {}
    p = str(tmp_path / "x.jpg")
    cv.imwrite(p, img, [cv.IMWRITE_JPEG_PROGRESSIVE, 1])
    cases["progressive jpeg"] = p
    p = str(tmp_path / "x16.png")
    cv.imwrite(p, img.astype(np.uint16) * 257)
    cases["16-bit"] = p
    p = str(tmp_path / "trunc.png")
    cv.imwrite(p, img)
    data = open(p, "rb").read()
    open(p, "wb").write(data[:len(data) // 2])
    cases["truncated"] = p
    p = str(tmp_path / "crc.png")
    cv.imwrite(p, img)
    data = bytearray(open(p, "rb").read())
    data[40] ^= 0xFF
    open(p, "wb").write(bytes(data))
    cases["damaged"] = p
    for what, path in cases.items():
        with pytest.raises(ValueError, match=os.path.basename(path)):
            imread(path)
    with pytest.raises(OSError):
        imread(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        imwrite(str(tmp_path / "f.png"), img.astype(np.float32))
