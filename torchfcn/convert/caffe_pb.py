"""Minimal protobuf wire-format reader for Caffe ``.caffemodel`` files.

Replaces the Caffe C++ proto runtime (the reference loads weights via
``caffe.Net(proto, weights, caffe.TEST)``, reference
scripts/fcn_object_detector.py:317) with a dependency-free parser that
understands exactly the subset of ``NetParameter`` needed to extract
per-layer weight blobs:

  NetParameter:    name=1(str), layer=100(LayerParameter, new format),
                   layers=2(V1LayerParameter, legacy format)
  LayerParameter:  name=1(str), type=2(str), blobs=7(BlobProto)
  V1LayerParameter:name=4(str), type=5(enum), blobs=6(BlobProto)
  BlobProto:       num=1 channels=2 height=3 width=4 (legacy dims),
                   data=5(packed float), shape=7(BlobShape), double_data=8
  BlobShape:       dim=1(packed int64)

Only wire types 0 (varint), 1 (64-bit), 2 (length-delimited), 5 (32-bit)
exist in these messages.

A copy of ``tpufcn/convert/caffe_pb.py`` (numpy only): importing that
module runs ``tpufcn/convert/__init__.py``, which imports JAX, and the port
imports without JAX.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yields (field_number, wire_type, value) over one message body.

    Raises ValueError when a field's payload runs past the end of the
    buffer — a truncated .caffemodel must fail loudly here, not load
    with silently short weight blobs."""
    pos = 0
    n = len(buf)
    while pos < n:
        try:
            key, pos = _read_varint(buf, pos)
        except IndexError:
            raise ValueError(f"truncated varint at byte {pos}") from None
        field, wire = key >> 3, key & 7
        if wire == 0:
            try:
                val, pos = _read_varint(buf, pos)
            except IndexError:
                raise ValueError(
                    f"truncated varint field {field} at byte {pos}") from None
        elif wire == 1:
            if pos + 8 > n:
                raise ValueError(f"truncated 64-bit field {field} "
                                 f"at byte {pos}")
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError(
                    f"truncated length-delimited field {field} at byte "
                    f"{pos}: declared {ln} bytes, {n - pos} remain")
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            if pos + 4 > n:
                raise ValueError(f"truncated 32-bit field {field} "
                                 f"at byte {pos}")
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")
        yield field, wire, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    dims_legacy = {}
    shape: List[int] = []
    data: List[np.ndarray] = []
    for field, wire, val in iter_fields(buf):
        if field in (1, 2, 3, 4) and wire == 0:
            dims_legacy[field] = int(val)
        elif field == 5:  # packed float data
            data.append(np.frombuffer(bytes(val), dtype="<f4"))
        elif field == 8:  # packed double data
            data.append(np.frombuffer(bytes(val), dtype="<f8").astype(np.float32))
        elif field == 7 and wire == 2:  # BlobShape
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        p = 0
                        mv = v2
                        while p < len(mv):
                            d, p = _read_varint(mv, p)
                            shape.append(d)
                    else:
                        shape.append(int(v2))
    arr = np.concatenate(data) if data else np.zeros(0, np.float32)
    if not shape and dims_legacy:
        shape = [dims_legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape:
        if int(np.prod(shape)) != arr.size:
            # corrupt/truncated blob: returning the flat array here let
            # convert_caffemodel silently skip the layer (leaving its
            # RANDOM init in place) even under strict=True
            raise ValueError(
                f"blob data size {arr.size} does not match declared "
                f"shape {tuple(shape)} — corrupt or truncated caffemodel")
        arr = arr.reshape(shape)
    return arr


def load_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """Parse a .caffemodel into {layer_name: [blob arrays]} (both the new
    ``layer`` and legacy ``layers`` formats)."""
    with open(path, "rb") as f:
        raw = memoryview(f.read())
    out: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in iter_fields(raw):
        if field == 100 and wire == 2:       # LayerParameter
            name, blobs = None, []
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1:
                    name = bytes(v2).decode("utf-8")
                elif f2 == 7:
                    blobs.append(_parse_blob(v2))
            if name and blobs:
                out[name] = blobs
        elif field == 2 and wire == 2:       # V1LayerParameter (legacy)
            name, blobs = None, []
            for f2, w2, v2 in iter_fields(val):
                if f2 == 4 and w2 == 2:
                    name = bytes(v2).decode("utf-8")
                elif f2 == 6 and w2 == 2:
                    blobs.append(_parse_blob(v2))
            if name and blobs:
                out[name] = blobs
    return out


# --- writer (used by tests and by the reverse exporter) -------------------

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2, _varint(len(payload)) + payload)


def blob_bytes(arr: np.ndarray) -> bytes:
    shape_msg = b"".join(_field(1, 0, _varint(int(d))) for d in arr.shape)
    data = arr.astype("<f4").tobytes()
    return (_len_field(7, shape_msg)
            + _len_field(5, data))


def write_caffemodel(path: str, layers: Dict[str, List[np.ndarray]],
                     net_name: str = "net") -> None:
    """Serialize {layer_name: [blobs]} as a new-format NetParameter."""
    body = _len_field(1, net_name.encode())
    for name, blobs in layers.items():
        layer = _len_field(1, name.encode())
        for b in blobs:
            layer += _len_field(7, blob_bytes(np.asarray(b)))
        body += _len_field(100, layer)
    with open(path, "wb") as f:
        f.write(body)
