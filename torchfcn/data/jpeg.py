"""A baseline JPEG codec in numpy, for the hosts without ``cv2`` (the card's
has none): ``decode`` is ``cv.imdecode(buf, cv.IMREAD_COLOR)`` and
``encode`` is ``cv.imencode(".jpg", img, [cv.IMWRITE_JPEG_QUALITY, q])``,
bit for bit and byte for byte, as OpenCV's libjpeg-turbo computes them.

Decoding reads baseline (SOF0) and extended (SOF1) sequential Huffman
files of 8-bit samples with 1 or 3 components, any sampling factors up to
2 x 2, in one or several scans, with or without restart intervals, and
without Huffman tables (Motion-JPEG frames: Annex K's, as libjpeg); a
progressive, arithmetic-coded, lossless or 12-bit file raises ``ValueError``
naming the file.  libjpeg-turbo's defaults are followed throughout: the
JDCT_ISLOW integer inverse DCT, "fancy" (triangular) upsampling of h2v1,
h1v2 and h2v2 chroma, fixed-point YCbCr -> RGB tables, and BGR output (a
gray file replicated to three channels).

``decode_ffmpeg`` decodes a Motion-JPEG frame as ``cv.VideoCapture`` does
through FFmpeg instead: the same coefficients, FFmpeg's ``simple_idct``,
chroma replicated and swscale's YUV -> BGR (``torchfcn.serve.video``).

Encoding writes what OpenCV writes by default: SOI, a JFIF APP0, one DQT per
table at the quality's scaling of the Annex K tables, SOF0 (4:2:0; one
component for a gray image), the four standard Huffman tables (no
optimisation), one interleaved scan and EOI; fixed-point
RGB -> YCbCr, h2v2 downsampling with the alternating 1/2 bias, the
JDCT_ISLOW forward DCT and libjpeg-turbo's reciprocal quantisation.

Colour transforms, sampling, DCTs and quantisation run vectorised over all
blocks; the Huffman bit-packing and unpacking is C++
(``jpeg_entropy.cpp``), built with ``g++`` into ``torchfcn/_build/`` at
first use.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SOI, EOI = b"\xff\xd8", b"\xff\xd9"

# natural (row-major) index of each zigzag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K's quantisation tables, natural order
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# Annex K's Huffman tables: 16 code counts, then the symbols
_STD_HUFFMAN = {
    "dc_luma": "00010501010101010100000000000000000102030405060708090a0b",
    "ac_luma": (
        "0002010303020403050504040000017d01020300041105122131410613516107"
        "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
        "292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    "dc_chroma": "00030101010101010101010000000000000102030405060708090a0b",
    "ac_chroma": (
        "0002010204040304070504040001027700010203110405213106124151076171"
        "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
        "2728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
        "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
STD_HUFFMAN = {k: bytes.fromhex(v) for k, v in _STD_HUFFMAN.items()}

# libjpeg's islow DCT constants, 13 fractional bits
CONST_BITS, PASS1_BITS = 13, 2
F_0_298, F_0_390, F_0_541, F_0_765 = 2446, 3196, 4433, 6270
F_0_899, F_1_175, F_1_501, F_1_847 = 7373, 9633, 12299, 15137
F_1_961, F_2_053, F_2_562, F_3_072 = 16069, 16819, 20995, 25172
# FFmpeg's simple_idct constants W1..W7: cos(i pi / 16) sqrt(2) 2^14
SIMPLE_W = (22725, 21407, 19266, 16383, 12873, 8867, 4520)
# swscale's 16-bit YUV -> RGB coefficients of BT.601 full range (its x86
# yuv2rgb: each term (8 * (c - 128) * k) >> 16, as pmulhw computes it)
SWS_UB, SWS_UG, SWS_VG, SWS_VR = 14516, -2819, -5850, 11485

# the colour transforms' 16-bit fixed point
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


# --- the entropy coder ---------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """``jpeg_entropy.cpp`` built with g++ into ``torchfcn/_build`` (once per
    source); a failed build raises."""
    from torchfcn.utils.native import build
    path = build("jpeg_entropy",
                 [Path(__file__).with_name("jpeg_entropy.cpp")], shared=True)
    lib = ctypes.CDLL(str(path))
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.tf_jpeg_decode_scan.argtypes = [p, l, l, i, p, p, i, i, i, p]
    lib.tf_jpeg_decode_scan.restype = l
    lib.tf_jpeg_encode_scan.argtypes = [p, i, p, p, p, i, i, p, l]
    lib.tf_jpeg_encode_scan.restype = l
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# --- integer DCTs (jfdctint.c, jidctint.c) --------------------------------

def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of jpeg_idct_islow over 8 int64 rows of inputs, each an
    array over blocks: the even and odd parts, descaled by ``shift``."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * F_0_541
    tmp2 = z1 + z3 * -F_1_847
    tmp3 = z1 + z2 * F_0_765
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F_1_175
    t0, t1, t2, t3 = t0 * F_0_298, t1 * F_2_053, t2 * F_3_072, t3 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) quantised coefficients in natural order and a (64,) table ->
    (N, 8, 8) uint8 samples: dequantise, columns then rows, the output
    centred on 128 and clamped (libjpeg-turbo's SIMD range limit)."""
    c = coefs.astype(np.int64).reshape(-1, 8, 8) * quant.reshape(8, 8)
    cols = _idct_1d([c[:, r, :] for r in range(8)],
                    CONST_BITS - PASS1_BITS)
    ws = np.stack(cols, axis=1)                      # (N, row, col)
    rows = _idct_1d([ws[:, :, k] for k in range(8)],
                    CONST_BITS + PASS1_BITS + 3)
    out = np.stack(rows, axis=2)                     # (N, row, col)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _int16(x: np.ndarray) -> np.ndarray:
    """``x`` stored to int16 (wrapping), kept as int64."""
    return ((x + 32768) & 0xFFFF) - 32768


def _simple_1d(x: List[np.ndarray], a0: np.ndarray) -> List[np.ndarray]:
    """The butterfly of FFmpeg's simple_idct over 8 inputs (arrays over
    blocks), ``a0`` the DC term with its rounding: the 8 unshifted sums."""
    w1, w2, w3, w4, w5, w6, w7 = SIMPLE_W
    a1, a2, a3 = a0, a0, a0
    a0, a1 = a0 + w2 * x[2] + w4 * x[4] + w6 * x[6], \
        a1 + w6 * x[2] - w4 * x[4] - w2 * x[6]
    a2, a3 = a2 - w6 * x[2] - w4 * x[4] + w2 * x[6], \
        a3 - w2 * x[2] + w4 * x[4] - w6 * x[6]
    b0 = w1 * x[1] + w3 * x[3] + w5 * x[5] + w7 * x[7]
    b1 = w3 * x[1] - w7 * x[3] - w1 * x[5] - w5 * x[7]
    b2 = w5 * x[1] - w1 * x[3] + w7 * x[5] + w3 * x[7]
    b3 = w7 * x[1] - w5 * x[3] + w3 * x[5] - w1 * x[7]
    return [a0 + b0, a1 + b1, a2 + b2, a3 + b3,
            a3 - b3, a2 - b2, a1 - b1, a0 - b0]


def idct_simple(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) quantised coefficients in natural order and a (64,) table ->
    (N, 8, 8) uint8 samples, as FFmpeg's MJPEG decoder computes them: the
    dequantised DC offset by 1024 (its DC predictor starts at ``4 << 8``,
    so the level shift rides in the DC), stored to int16, then
    ``simple_idct_put``: rows (shift 11, and a row of DC only becomes
    ``8 * DC``), columns (shift 20, the rounding folded into the DC as
    ``W4 * (c0 + 32)``), clamped."""
    c = coefs.astype(np.int64).reshape(-1, 64) * quant
    c[:, 0] += 1024
    c = _int16(c).reshape(-1, 8, 8)
    row = [c[:, :, k] for k in range(8)]                # (N, row) each
    sums = _simple_1d(row, SIMPLE_W[3] * row[0] + (1 << 10))
    rows = np.stack([_int16(s >> 11) for s in sums], axis=2)
    dc_only = ~c[:, :, 1:].any(axis=2)
    rows = np.where(dc_only[:, :, None], _int16(row[0] * 8)[:, :, None],
                    rows)                                # (N, row, col)
    col = [rows[:, r, :] for r in range(8)]
    sums = _simple_1d(col, SIMPLE_W[3] * (col[0] + (1 << 19) // SIMPLE_W[3]))
    out = np.stack([s >> 20 for s in sums], axis=1)     # (N, row, col)
    return np.clip(out, 0, 255).astype(np.uint8)


def _fdct_1d(d: List[np.ndarray], even_shift: Optional[int], odd_shift: int
             ) -> List[np.ndarray]:
    """One pass of jpeg_fdct_islow; ``even_shift`` None scales outputs 0
    and 4 up by PASS1_BITS (pass 1), else descales them by it."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out: List[np.ndarray] = [None] * 8
    if even_shift is None:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, even_shift)
        out[4] = _descale(tmp10 - tmp11, even_shift)
    z1 = (tmp12 + tmp13) * F_0_541
    out[2] = _descale(z1 + tmp13 * F_0_765, odd_shift)
    out[6] = _descale(z1 + tmp12 * -F_1_847, odd_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F_1_175
    tmp4, tmp5 = tmp4 * F_0_298, tmp5 * F_2_053
    tmp6, tmp7 = tmp6 * F_3_072, tmp7 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    out[7] = _descale(tmp4 + z1 + z3, odd_shift)
    out[5] = _descale(tmp5 + z2 + z4, odd_shift)
    out[3] = _descale(tmp6 + z2 + z3, odd_shift)
    out[1] = _descale(tmp7 + z1 + z4, odd_shift)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 64) int64 DCT outputs, natural order,
    scaled up by 8 (jpeg_fdct_islow on samples centred on 0): rows first."""
    d = blocks.astype(np.int64) - 128
    rows = _fdct_1d([d[:, :, k] for k in range(8)], None,
                    CONST_BITS - PASS1_BITS)
    ws = np.stack(rows, axis=2)                      # (N, row, u)
    cols = _fdct_1d([ws[:, r, :] for r in range(8)], PASS1_BITS,
                    CONST_BITS + PASS1_BITS)
    return np.stack(cols, axis=1).reshape(-1, 64)    # (N, v, u)


def quantize(dct: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantisation (jcdctmgr.c, built with SIMD: 16-bit
    DCT elements): |x| plus a correction, times a reciprocal of q * 8, shifted;
    the sign restored.  (N, 64) -> (N, 64) int16."""
    out = np.empty_like(dct)
    for i, q in enumerate(quant):
        divisor = int(q) << 3
        b = divisor.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, divisor)
        c = divisor // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= divisor // 2:
            c += 1
        else:
            fq += 1
        x = dct[:, i]
        mag = ((np.abs(x) + c) * fq) >> r
        out[:, i] = np.where(x < 0, -mag, mag)
    return out.astype(np.int16)


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """jpeg_set_quality(quality, force_baseline=TRUE): the Annex K tables
    scaled, each entry clamped to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMA_QUANT, STD_CHROMA_QUANT))


# --- colour and sampling -------------------------------------------------

def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes -> (H, W, 3) BGR."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((_fix(1.40200) * cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-_fix(0.34414) * cb + ONE_HALF - _fix(0.71414) * cr)
             >> SCALEBITS)
    b = y + ((_fix(1.77200) * cb + ONE_HALF) >> SCALEBITS)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def ycc_to_bgr_swscale(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                       full_chroma: bool = False) -> np.ndarray:
    """swscale's full-range YUV -> BGR24 of uint8 planes of one size ->
    (H, W, 3), saturated.  Its unscaled converter (subsampled chroma):
    each chroma term the high half of a 16-bit product, truncated, G the
    sum of two such terms.  With ``full_chroma`` (chroma not subsampled,
    its output stage ``yuv2rgb_write_full``): the same coefficients in one
    sum over 22 fractional bits, rounded."""
    y = y.astype(np.int64)
    u = (cb.astype(np.int64) - 128) * 8
    v = (cr.astype(np.int64) - 128) * 8
    if full_chroma:
        y = (y << 22) + (1 << 21)
        bgr = [(y + (u * SWS_UB << 6)) >> 22,
               (y + (u * SWS_UG + v * SWS_VG << 6)) >> 22,
               (y + (v * SWS_VR << 6)) >> 22]
    else:
        bgr = [y + ((u * SWS_UB) >> 16),
               y + ((u * SWS_UG) >> 16) + ((v * SWS_VG) >> 16),
               y + ((v * SWS_VR) >> 16)]
    return np.clip(np.stack(bgr, axis=-1), 0, 255).astype(np.uint8)


def bgr_to_ycc(img: np.ndarray) -> Tuple[np.ndarray, ...]:
    """jccolor.c's rgb_ycc_convert of a uint8 BGR image -> Y, Cb, Cr."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    off = (128 << SCALEBITS) + ONE_HALF - 1
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + off) >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + off) >> SCALEBITS
    return tuple(p.astype(np.uint8) for p in (y, cb, cr))


def _neighbours(a: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """(previous, next) along ``axis``, the edges replicated."""
    n = a.shape[axis]
    prev = np.take(a, np.r_[0, np.arange(n - 1)], axis=axis)
    nxt = np.take(a, np.r_[np.arange(1, n), n - 1], axis=axis)
    return prev, nxt


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """jdsample.c at libjpeg-turbo's defaults: h2v2 and h2v1 "fancy" (a
    triangular filter with alternating biases) for planes wider than 2
    samples, h1v2 fancy, else replication."""
    p = plane.astype(np.int64)
    if (fx, fy) == (1, 1):
        return plane
    fancy_h = plane.shape[1] > 2
    if (fx, fy) == (2, 2) and fancy_h:
        up, down = _neighbours(p, 0)
        near = 3 * p
        rows = _interleave(near + up, near + down, 0)    # column sums
        left, right = _neighbours(rows, 1)
        out = _interleave((3 * rows + left + 8) >> 4,
                          (3 * rows + right + 7) >> 4, 1)
    elif (fx, fy) == (2, 1) and fancy_h:
        left, right = _neighbours(p, 1)
        out = _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1)
    elif (fx, fy) == (1, 2):
        up, down = _neighbours(p, 0)
        out = _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0)
    else:
        out = np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)
    return out.astype(np.uint8)


def _downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c's h2v2_downsample of a plane padded to even sizes: each
    2 x 2 sum plus the bias 1, 2, 1, 2 ... along the row, shifted by 2."""
    p = plane.astype(np.int64)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return ((s + bias) >> 2).astype(np.uint8)


def _pad_edge(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])),
                  mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8R, 8C) -> (R * C, 8, 8), row-major over the blocks."""
    r, c = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(r, 8, c, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _unblocks(blocks: np.ndarray, r: int, c: int) -> np.ndarray:
    return blocks.reshape(r, c, 8, 8).transpose(0, 2, 1, 3).reshape(
        8 * r, 8 * c)


# --- markers ----------------------------------------------------------------

def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None


_UNSUPPORTED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded "
    "progressive", 0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-"
    "coded differential sequential", 0xCE: "arithmetic-coded differential "
    "progressive", 0xCF: "arithmetic-coded differential lossless"}


def decode(data: bytes, name: str = "<buffer>") -> np.ndarray:
    """(H, W, 3) uint8 BGR pixels of a baseline JPEG, as ``cv.imdecode(buf,
    cv.IMREAD_COLOR)`` gives them.  ``name`` names the file in errors."""
    return _to_bgr(*parse(data, name))


def ffmpeg_planes(data: bytes, name: str = "<buffer>"
                  ) -> Tuple[List[np.ndarray], Tuple[int, int]]:
    """The (H, W) uint8 planes of a Motion-JPEG frame as FFmpeg's MJPEG
    decoder gives them (``idct_simple``), each chroma plane replicated over
    its sampling factors: ([Y] of a gray frame, else [Y, Cb, Cr]; the
    chroma's (horizontal, vertical) subsampling, (1, 1) for gray)."""
    comps, coefs, (h, w), _, _ = parse(data, name)
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.quant is None:               # never scanned: zeros, as libjpeg
            c.quant = np.zeros(64, np.int64)
        blk = coefs[c.offset:c.offset + c.bw * c.bh]
        plane = _unblocks(idct_simple(blk, c.quant), c.bh, c.bw)
        plane = np.repeat(np.repeat(plane, vmax // c.v, axis=0),
                          hmax // c.h, axis=1)
        planes.append(plane[:h, :w])
    return planes, (hmax // comps[-1].h, vmax // comps[-1].v)


def decode_ffmpeg(data: bytes, name: str = "<buffer>") -> np.ndarray:
    """(H, W, 3) uint8 BGR pixels of a Motion-JPEG frame as
    ``cv.VideoCapture(path)`` gives them through FFmpeg: its MJPEG decoder
    (``ffmpeg_planes``), then swscale to BGR24 (``ycc_to_bgr_swscale``),
    whose unscaled converter takes 4:2:0 and 4:2:2 frames of even height
    and whose full-chroma output stage takes 4:4:4 ones; a gray frame
    replicated to three channels.  Other frames (odd heights, 4:4:0) go
    through swscale's bicubic chroma scaler, which is not copied: their
    chroma is replicated as for the unscaled converter."""
    planes, sub = ffmpeg_planes(data, name)
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    return ycc_to_bgr_swscale(*planes, full_chroma=sub == (1, 1))


def parse(data: bytes, name: str = "<buffer>"):
    """The markers and entropy-coded scans of a baseline JPEG: (components,
    their quantised coefficients (blocks, 64) int16 in natural order, each
    component's blocks from its ``offset``, row-major over ``bw`` x ``bh``
    blocks; (H, W); JFIF; the Adobe transform or None)."""
    data = bytes(data)
    if not data.startswith(SOI):
        raise ValueError(f"{name}: not a JPEG file")
    quant: Dict[int, np.ndarray] = {}
    huff = np.zeros((8, 272), np.uint8)
    defined = set()                   # rows of ``huff`` a DHT has set
    comps: List[_Component] = []
    size = None
    restart, adobe_transform, jfif = 0, None, False
    coefs = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1                                  # fill bytes
        if pos + 4 > len(data) or data[pos] != 0xFF:
            if coefs is not None:
                break                                 # no EOI: as libjpeg
            raise ValueError(f"{name}: JPEG data ends before its image")
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if len(body) != length - 2:
            raise ValueError(f"{name}: truncated JPEG segment {marker:#x}")
        pos += 2 + length
        if marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{name}: {_UNSUPPORTED_SOF[marker]} JPEG "
                             f"(SOF{marker - 0xC0}): only baseline sequential "
                             f"Huffman files are read")
        if marker in (0xC0, 0xC1):
            precision, h, w, n = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit JPEG samples: "
                                 f"only 8-bit samples are read")
            if n not in (1, 3) or h == 0 or w == 0:
                raise ValueError(f"{name}: a JPEG of {n} components and "
                                 f"size {w}x{h} is not read")
            comps = []
            for i in range(n):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                ch, cv_ = hv >> 4, hv & 15
                if not (1 <= ch <= 2 and 1 <= cv_ <= 2):
                    raise ValueError(f"{name}: sampling {ch}x{cv_} is not "
                                     f"read (at most 2x2)")
                comps.append(_Component(cid, ch, cv_, tq))
            size = (h, w)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcus_x, mcus_y = _ceil_div(w, 8 * hmax), _ceil_div(h, 8 * vmax)
            offset = 0
            for c in comps:
                c.bw, c.bh = mcus_x * c.h, mcus_y * c.v   # stored blocks
                c.wib = _ceil_div(_ceil_div(w * c.h, hmax), 8)
                c.hib = _ceil_div(_ceil_div(h * c.v, vmax), 8)
                c.offset = offset
                offset += c.bw * c.bh
            coefs = np.zeros((offset, 64), np.int16)
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = struct.unpack(">64H", body[i + 1:i + 129])
                    i += 129
                else:
                    vals = tuple(body[i + 1:i + 65])
                    i += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                quant[tq] = table
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                row = huff[4 * tc + th]
                row[:] = 0
                row[:16] = np.frombuffer(counts, np.uint8)
                row[16:16 + n] = np.frombuffer(body[i + 17:i + 17 + n],
                                               np.uint8)
                defined.add(4 * tc + th)
                i += 17 + n
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:
            if coefs is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            _standard_tables(huff, defined)
            pos = _decode_scan(data, pos, body, comps, quant, huff, defined,
                               restart, coefs, name)
        elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe_transform = body[11]
    if coefs is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    return comps, coefs, size, jfif, adobe_transform


# rows of the decoder's Huffman tables (4 * class + slot) that libjpeg
# fills with Annex K's tables when no DHT has set them: Motion-JPEG frames
# (a camera's AVI1 frames) leave them out
_STANDARD_ROWS = {0: "dc_luma", 1: "dc_chroma", 4: "ac_luma", 5: "ac_chroma"}


def _standard_tables(huff: np.ndarray, defined: set) -> None:
    """Annex K's tables in DC and AC slots 0 and 1 where no DHT set them, as
    libjpeg's ``std_huff_tables`` installs them when its Huffman decoder
    starts."""
    for row, table in _STANDARD_ROWS.items():
        if row not in defined:
            spec = STD_HUFFMAN[table]
            huff[row] = 0
            huff[row, :len(spec)] = np.frombuffer(spec, np.uint8)
            defined.add(row)


def _decode_scan(data: bytes, pos: int, body: bytes, comps, quant, huff,
                 defined: set, restart: int, coefs: np.ndarray,
                 name: str) -> int:
    n = body[0]
    desc, scan = [], []
    for i in range(n):
        cid, tables = body[1 + 2 * i], body[2 + 2 * i]
        c = next((c for c in comps if c.id == cid), None)
        if c is None:
            raise ValueError(f"{name}: scan names unknown component {cid}")
        if c.quant is None:
            if c.tq not in quant:
                raise ValueError(f"{name}: no quantisation table {c.tq}")
            c.quant = quant[c.tq]         # latched at its first scan
        for row in (tables >> 4, 4 + (tables & 15)):
            if row not in defined:
                raise ValueError(f"{name}: Huffman table {row >> 2}/"
                                 f"{row & 3} was not defined")
        scan.append(c)
        desc.append((tables >> 4, tables & 15, c))
    if n == 1:
        c = scan[0]
        geom = [(desc[0][0], desc[0][1], 1, 1, c.bw, c.offset)]
        mcus_x, mcus_y = c.wib, c.hib
    else:
        geom = [(dc, ac, c.h, c.v, c.bw, c.offset) for dc, ac, c in desc]
        mcus_x = scan[0].bw // scan[0].h
        mcus_y = scan[0].bh // scan[0].v
    g = np.asarray(geom, np.int32)
    buf = np.frombuffer(data, np.uint8)
    end = _lib().tf_jpeg_decode_scan(
        _ptr(buf), len(data), pos, n, _ptr(g), _ptr(huff), mcus_x, mcus_y,
        restart, _ptr(coefs))
    if end < 0:
        what = {-1: "a bad Huffman code", -2: "a missing restart marker",
                -3: "a coefficient run past its block"}[end]
        raise ValueError(f"{name}: corrupt JPEG data ({what})")
    return int(end)


def _to_bgr(comps, coefs, size, jfif: bool, adobe_transform) -> np.ndarray:
    h, w = size
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.quant is None:               # never scanned: zeros, as libjpeg
            c.quant = np.zeros(64, np.int64)
        blk = coefs[c.offset:c.offset + c.bw * c.bh]
        plane = _unblocks(idct_islow(blk, c.quant), c.bh, c.bw)
        plane = plane[:_ceil_div(h * c.v, vmax), :_ceil_div(w * c.h, hmax)]
        planes.append(upsample(plane, hmax // c.h, vmax // c.v)[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    rgb_ids = [c.id for c in comps] == [ord("R"), ord("G"), ord("B")]
    if adobe_transform == 0 or (not jfif and adobe_transform is None
                                and rgb_ids):
        return np.stack(planes[::-1], axis=-1)
    return ycc_to_bgr(*planes)


def encode(img: np.ndarray, quality: int = 95) -> bytes:
    """A (H, W, 3) BGR or (H, W) gray uint8 image as the JPEG file
    ``cv.imencode(".jpg", img, [cv.IMWRITE_JPEG_QUALITY, quality])``
    writes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        planes, samp = [img], [(1, 1)]
    elif img.ndim == 3 and img.shape[2] == 3:
        planes = list(bgr_to_ycc(img))
        samp = [(2, 2), (1, 1), (1, 1)]
    else:
        raise ValueError(f"encode takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG cannot hold {w}x{h}")
    luma_q, chroma_q = quality_tables(quality)
    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    mcus_x, mcus_y = _ceil_div(w, 8 * hmax), _ceil_div(h, 8 * vmax)
    if len(planes) == 1:                  # non-interleaved: no MCU padding
        mcus_x, mcus_y = _ceil_div(w, 8), _ceil_div(h, 8)
    blocks, geom, offset = [], [], 0
    for ci, (plane, (ch, cv_)) in enumerate(zip(planes, samp)):
        fx, fy = hmax // ch, vmax // cv_
        wib = _ceil_div(_ceil_div(w * ch, hmax), 8)
        hib = _ceil_div(_ceil_div(h * cv_, vmax), 8)
        bw, bh = mcus_x * ch, mcus_y * cv_
        # pad the full-size plane to whole sample pairs and the blocks' width
        down = _pad_edge(plane, _ceil_div(h, vmax) * vmax, wib * 8 * fx)
        if (fx, fy) == (2, 2):
            down = _downsample_h2v2(down)
        down = _pad_edge(down, bh * 8, bw * 8)
        q = luma_q if ci == 0 else chroma_q
        coef = quantize(fdct_islow(_blocks(down)), q).reshape(bh, bw, 64)
        # dummy blocks past the component's edge in its last MCUs: zero AC
        # and the DC of the block before them (jccoefct.c)
        for col in range(wib, bw):
            coef[:hib, col] = 0
            coef[:hib, col, 0] = coef[:hib, col - 1, 0]
        for row in range(hib, bh):
            coef[row] = 0
            last = (np.arange(bw) // ch) * ch + ch - 1
            coef[row, :, 0] = coef[row - 1, last, 0]
        blocks.append(coef.reshape(-1, 64))
        dc = ac = 0 if ci == 0 else 1
        geom.append((dc, ac, ch if len(planes) > 1 else 1,
                     cv_ if len(planes) > 1 else 1, bw, offset))
        offset += bw * bh
    coefs = np.ascontiguousarray(np.concatenate(blocks), np.int16)
    codes, sizes = _encode_tables()
    g = np.asarray(geom, np.int32)
    cap = 512 * coefs.shape[0] + 1024
    out = np.zeros(cap, np.uint8)
    n = _lib().tf_jpeg_encode_scan(_ptr(coefs), len(planes), _ptr(g),
                                   _ptr(codes), _ptr(sizes), mcus_x, mcus_y,
                                   _ptr(out), cap)
    if n < 0:
        raise RuntimeError("JPEG entropy coder overflowed its buffer")
    return _headers(h, w, samp, luma_q, chroma_q) + out[:n].tobytes() + EOI


def _headers(h: int, w: int, samp, luma_q, chroma_q) -> bytes:
    gray = len(samp) == 1
    out = [SOI, _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00"
                         b"\x00")]
    for tq, table in enumerate((luma_q,) if gray else (luma_q, chroma_q)):
        out.append(_segment(0xDB, bytes([tq]) + bytes(
            int(v) for v in table[ZIGZAG])))
    sof = struct.pack(">BHHB", 8, h, w, len(samp))
    for ci, (ch, cv_) in enumerate(samp):
        sof += bytes([ci + 1, (ch << 4) | cv_, 0 if ci == 0 else 1])
    out.append(_segment(0xC0, sof))
    for kind, name in ((0x00, "dc_luma"), (0x10, "ac_luma"),
                       (0x01, "dc_chroma"), (0x11, "ac_chroma")):
        if gray and kind & 1:
            break
        out.append(_segment(0xC4, bytes([kind]) + STD_HUFFMAN[name]))
    sos = bytes([len(samp)])
    for ci in range(len(samp)):
        sos += bytes([ci + 1, 0x00 if ci == 0 else 0x11])
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    return b"".join(out)


@functools.lru_cache(maxsize=1)
def _encode_tables() -> Tuple[np.ndarray, np.ndarray]:
    """Code words and lengths of every symbol of the standard tables: DC
    luma and chroma in rows 0 and 1, AC luma and chroma in rows 4 and 5
    (jpeg_entropy.cpp's table numbering)."""
    codes = np.zeros((8, 256), np.uint32)
    sizes = np.zeros((8, 256), np.uint8)
    for row, name in ((0, "dc_luma"), (1, "dc_chroma"), (4, "ac_luma"),
                      (5, "ac_chroma")):
        spec = STD_HUFFMAN[name]
        code, k = 0, 16
        for length in range(1, 17):
            for _ in range(spec[length - 1]):
                codes[row, spec[k]] = code
                sizes[row, spec[k]] = length
                code += 1
                k += 1
            code <<= 1
    return codes, sizes


def read(path: str) -> np.ndarray:
    """``cv.imread(path)`` of a JPEG file (BGR uint8)."""
    with open(path, "rb") as f:
        return decode(f.read(), path)
