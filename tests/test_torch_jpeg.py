"""The port's baseline JPEG codec (``torchfcn/data/jpeg.py``) against cv2
(OpenCV 5.0's libjpeg-turbo):

* decoding bit-equal to ``cv.imdecode(buf, IMREAD_COLOR)`` on the 144
  fixture JPEGs of ``tests/fixtures/voc_mini``, on cv2's encodes of seeded
  random and smoothed images at qualities 50 / 75 / 95 and sampling
  4:2:0 / 4:4:4, of odd sizes and of a gray image, and on streams with
  restart intervals;
* encoding byte-equal to ``cv.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY,
  95])`` on the same images;
* progressive, arithmetic-coded and 12-bit files raising ``ValueError``
  that names them;
* the fixture digests that ``chip_smoke.py`` holds the card's host to;
* the C++ entropy decoder's coefficients equal to a plain-Python bit
  reader's on a fixture image, and the plain reader's time per image (the
  reason the Huffman coding is C++).
"""

import glob
import hashlib
import os
import struct
import time

import cv2 as cv
import numpy as np
import pytest

import chip_smoke
from torchfcn.data import jpeg
from torchfcn.data.imageio import imread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "voc_mini", "JPEGImages")
FILES = sorted(glob.glob(os.path.join(FIXTURE, "*.jpg")))
# (H, W[, 3]): odd sizes (17x9, 33x47), partial MCUs, single blocks, gray
SHAPES = [(9, 17, 3), (47, 33, 3), (33, 47, 3), (240, 320, 3), (8, 8, 3),
          (1, 1, 3), (2, 3, 3), (18, 34, 3), (33, 47)]
SAMPLING = {"420": cv.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "444": cv.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def _images(shape, seed=0):
    """A seeded random image and a smoothed one (the entropy coder sees long
    zero runs in the second)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, np.uint8)
    return img, cv.GaussianBlur(img, (7, 7), 0)


def _cv_encode(img, quality=95, sampling="420", *extra):
    ok, enc = cv.imencode(".jpg", img, [
        cv.IMWRITE_JPEG_QUALITY, quality,
        cv.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling], *extra])
    assert ok
    return enc.tobytes()


def test_fixture_decodes_bit_equal_to_cv2():
    assert len(FILES) == 144
    for path in FILES:
        got = imread(path)
        want = cv.imread(path)
        assert got.shape == want.shape == (240, 320, 3), path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_fixture_digests_match_chip_smoke():
    """The digests that chip_smoke.py checks on the card's host (which has
    no cv2), from cv2 here, and the port's equal to them."""
    dec, enc = hashlib.sha256(), hashlib.sha256()
    port_dec, port_enc = hashlib.sha256(), hashlib.sha256()
    for path in FILES:
        raw = open(path, "rb").read()
        img = cv.imdecode(np.frombuffer(raw, np.uint8), cv.IMREAD_COLOR)
        dec.update(img.tobytes())
        enc.update(_cv_encode(img))
        mine = jpeg.decode(raw, path)
        port_dec.update(mine.tobytes())
        port_enc.update(jpeg.encode(mine, 95))
    print(f"fixture digests: decode {dec.hexdigest()}, q95 encode "
          f"{enc.hexdigest()}")
    assert dec.hexdigest() == port_dec.hexdigest() == \
        chip_smoke.FIXTURE_DECODE_SHA256
    assert enc.hexdigest() == port_enc.hexdigest() == \
        chip_smoke.FIXTURE_ENCODE_SHA256


@pytest.mark.parametrize("sampling", ["420", "444"])
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_decode_matches_cv2_encodes(shape, quality, sampling):
    for img in _images(shape, seed=quality):
        buf = _cv_encode(img, quality, sampling)
        want = cv.imdecode(np.frombuffer(buf, np.uint8), cv.IMREAD_COLOR)
        np.testing.assert_array_equal(jpeg.decode(buf), want)


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_decode_restart_intervals(interval):
    for img in _images((45, 61, 3), seed=interval):
        buf = _cv_encode(img, 80, "420", cv.IMWRITE_JPEG_RST_INTERVAL,
                         interval)
        assert b"\xff\xdd" in buf and b"\xff\xd0" in buf
        want = cv.imdecode(np.frombuffer(buf, np.uint8), cv.IMREAD_COLOR)
        np.testing.assert_array_equal(jpeg.decode(buf), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_encode_byte_equal_to_cv2_q95(shape):
    for img in _images(shape, seed=7):
        assert jpeg.encode(img) == _cv_encode(img)


def test_encode_other_qualities_byte_equal():
    for img in _images((47, 33, 3), seed=3):
        for quality in (1, 10, 50, 75, 100):
            assert jpeg.encode(img, quality) == _cv_encode(img, quality)


def test_unsupported_files_raise_by_name():
    img = _images((20, 30, 3))[1]
    ok, prog = cv.imencode(".jpg", img, [cv.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match=r"prog\.jpg: progressive JPEG"):
        jpeg.decode(prog.tobytes(), "prog.jpg")
    base = bytearray(_cv_encode(img))
    sof = base.find(b"\xff\xc0")
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match=r"twelve\.jpg: 12-bit JPEG"):
        jpeg.decode(bytes(twelve), "twelve.jpg")
    arith = bytearray(base)
    arith[sof + 1] = 0xC9
    with pytest.raises(ValueError, match=r"arith\.jpg: arithmetic-coded"):
        jpeg.decode(bytes(arith), "arith.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"\x89PNG....", "x.png")


def _python_scan_coefficients(data: bytes):
    """The quantised coefficients of a one-scan, interleaved, restart-free
    baseline JPEG, decoded by a plain-Python bit reader (independent of
    jpeg_entropy.cpp): per component an array (blocks, 64), natural
    order."""
    pos, huff, comps = 2, {}, []
    while True:
        marker, length = data[pos + 1], struct.unpack(
            ">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xC4:
            i = 0
            while i < len(body):
                counts, n = body[i + 1:i + 17], sum(body[i + 1:i + 17])
                codes, code, k = {}, 0, 0
                for size in range(1, 17):
                    for _ in range(counts[size - 1]):
                        codes[(size, code)] = body[i + 17 + k]
                        code, k = code + 1, k + 1
                    code <<= 1
                huff[body[i]] = codes
                i += 17 + n
        elif marker == 0xC0:
            h, w, n = struct.unpack(">HHB", body[1:6])
            comps = [(body[6 + 3 * c], body[7 + 3 * c] >> 4,
                      body[7 + 3 * c] & 15) for c in range(n)]
        elif marker == 0xDA:
            tables = {body[1 + 2 * c]: body[2 + 2 * c] for c in range(body[0])}
            break
    bits = []
    while pos < len(data):
        b = data[pos]
        if b == 0xFF:
            if data[pos + 1] != 0:
                break
            pos += 1
        bits.extend((b >> s) & 1 for s in range(7, -1, -1))
        pos += 1
    at = [0]

    def read(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | bits[at[0]]
            at[0] += 1
        return v

    def symbol(codes):
        code = size = 0
        while True:
            code, size = (code << 1) | read(1), size + 1
            if (size, code) in codes:
                return codes[(size, code)]

    def extend(v, s):
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out = [np.zeros((my * v, mx * hh, 64), np.int64) for _, hh, v in comps]
    pred = [0] * len(comps)
    for j in range(my):
        for i in range(mx):
            for c, (cid, hh, v) in enumerate(comps):
                dc_t, ac_t = huff[tables[cid] >> 4], huff[0x10 |
                                                         tables[cid] & 15]
                for y in range(v):
                    for x in range(hh):
                        blk = out[c][j * v + y, i * hh + x]
                        s = symbol(dc_t)
                        pred[c] += extend(read(s), s) if s else 0
                        blk[0] = pred[c]
                        k = 1
                        while k < 64:
                            rs = symbol(ac_t)
                            if rs & 15:
                                k += rs >> 4
                                blk[jpeg.ZIGZAG[k]] = extend(read(rs & 15),
                                                             rs & 15)
                                k += 1
                            elif rs == 0xF0:
                                k += 16
                            else:
                                break
    return [o.reshape(-1, 64) for o in out]


def test_entropy_decoder_matches_a_python_bit_reader():
    raw = open(FILES[0], "rb").read()
    t = time.perf_counter()
    want = _python_scan_coefficients(raw)
    python_s = time.perf_counter() - t
    comps, coefs, *_ = jpeg.parse(raw, FILES[0])
    t = time.perf_counter()
    jpeg.parse(raw, FILES[0])
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    jpeg.decode(raw, FILES[0])
    numpy_s = time.perf_counter() - t - native_s
    for c, w in zip(comps, want):
        got = coefs[c.offset:c.offset + c.bw * c.bh].astype(np.int64)
        np.testing.assert_array_equal(got, w)
    print(f"one 320x240 fixture image: plain-Python Huffman decode "
          f"{1e3 * python_s:.1f} ms (with the numpy stages' "
          f"{1e3 * numpy_s:.1f} ms, {1e3 * (python_s + numpy_s):.1f} ms an "
          f"image); the C++ coder with the marker parse "
          f"{1e3 * native_s:.2f} ms")
