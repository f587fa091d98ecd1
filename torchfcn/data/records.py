"""Sharded binary record storage of the port (``tpufcn/data/records.py``),
the LMDB replacement: the same files, byte for byte, without ``cv2``.

  shard:  magic "TFCR" + records, each  u64 payload_len | payload
  index:  magic "TFCI" + u64 offsets
  payload: u32 n_items, then per item
           u16 key_len | key utf8 | u16 dtype_len | dtype str |
           u8 ndim | ndim * u64 dims | raw little-endian data

No pickle: records are plain tagged numpy buffers.  Images are stored
JPEG-encoded at quality 95 (key suffix "/jpeg") by ``torchfcn.data.jpeg``,
which writes what ``cv.imencode`` writes and decodes as ``cv.imdecode``
does, so the port reads tpufcn's shards and tpufcn reads the port's.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

from torchfcn.data import jpeg
from torchfcn.data.imageio import imread_or_none
from torchfcn.data.raster import flip_image_with_rects, gaussian_blur_u8

_SHARD_MAGIC = b"TFCR"
_INDEX_MAGIC = b"TFCI"
JPEG_QUALITY = 95


def _pack(record: Dict[str, np.ndarray]) -> bytes:
    out = [struct.pack("<I", len(record))]
    for key, arr in record.items():
        arr = np.ascontiguousarray(arr)
        kb = key.encode()
        db = str(arr.dtype.str).encode()
        out.append(struct.pack("<H", len(kb)) + kb)
        out.append(struct.pack("<H", len(db)) + db)
        out.append(struct.pack("<B", arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}Q", *arr.shape) if arr.ndim else b"")
        out.append(arr.tobytes())
    return b"".join(out)


def _unpack(buf: bytes) -> Dict[str, np.ndarray]:
    pos = 0
    (n,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    out = {}
    for _ in range(n):
        (kl,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        key = buf[pos:pos + kl].decode()
        pos += kl
        (dl,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        dtype = np.dtype(buf[pos:pos + dl].decode())
        pos += dl
        (nd,) = struct.unpack_from("<B", buf, pos)
        pos += 1
        shape = struct.unpack_from(f"<{nd}Q", buf, pos) if nd else ()
        pos += 8 * nd
        count = int(np.prod(shape)) if nd else 1
        nbytes = count * dtype.itemsize
        out[key] = np.frombuffer(buf[pos:pos + nbytes],
                                 dtype=dtype).reshape(shape)
        pos += nbytes
    return out


class RecordWriter:
    """Append records to sharded files ``<prefix>-NNNNN.rec`` (+ .idx)."""

    def __init__(self, prefix: str, records_per_shard: int = 4096):
        self.prefix = prefix
        self.records_per_shard = records_per_shard
        self._shard_no = -1
        self._file = None
        self._offsets: List[int] = []
        self._count = 0
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    def _roll(self):
        self._close_shard()
        self._shard_no += 1
        self._file = open(f"{self.prefix}-{self._shard_no:05d}.rec", "wb")
        self._file.write(_SHARD_MAGIC)
        self._offsets = []
        self._count = 0

    def write(self, record: Dict[str, np.ndarray]) -> None:
        if self._file is None or self._count >= self.records_per_shard:
            self._roll()
        payload = _pack(record)
        self._offsets.append(self._file.tell())
        self._file.write(struct.pack("<Q", len(payload)))
        self._file.write(payload)
        self._count += 1

    def write_image_record(self, image_bgr: np.ndarray,
                           extra: Dict[str, np.ndarray]) -> None:
        enc = jpeg.encode(image_bgr, JPEG_QUALITY)
        rec = {"image/jpeg": np.frombuffer(enc, np.uint8)}
        rec.update(extra)
        self.write(rec)

    def _close_shard(self):
        if self._file is not None:
            path = self._file.name
            self._file.close()
            with open(os.path.splitext(path)[0] + ".idx", "wb") as f:
                f.write(_INDEX_MAGIC)
                f.write(struct.pack(f"<{len(self._offsets)}Q", *self._offsets))
            self._file = None

    def close(self):
        self._close_shard()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Random access and iteration over a set of shards.

    Shard handles open lazily and stay open for the reader's lifetime, so an
    instance is not safe for concurrent ``read`` from several threads (seek
    and read interleave on the shared handle): give each worker its own.
    Instances pickle without their handles, which reopen in the child."""

    def __init__(self, prefix: str):
        self.shards = sorted(
            f for f in _glob_prefix(prefix) if f.endswith(".rec"))
        if not self.shards:
            raise FileNotFoundError(f"no shards for prefix {prefix}")
        self._offsets = []
        for s in self.shards:
            with open(os.path.splitext(s)[0] + ".idx", "rb") as f:
                raw = f.read()
            if raw[:4] != _INDEX_MAGIC:
                raise ValueError(f"{s}: index without its magic")
            self._offsets.append(np.frombuffer(raw[4:], "<u8"))
        self._cum = np.cumsum([0] + [len(o) for o in self._offsets])
        self._handles: List = [None] * len(self.shards)

    def __len__(self) -> int:
        return int(self._cum[-1])

    def read(self, index: int) -> Dict[str, np.ndarray]:
        shard = int(np.searchsorted(self._cum, index, side="right") - 1)
        local = index - self._cum[shard]
        f = self._handles[shard]
        if f is None:
            f = self._handles[shard] = open(self.shards[shard], "rb")
        f.seek(int(self._offsets[shard][local]))
        (ln,) = struct.unpack("<Q", f.read(8))
        return self._decode(_unpack(f.read(ln)), self.shards[shard])

    def close(self):
        for f in self._handles:
            if f is not None:
                f.close()
        self._handles = [None] * len(self.shards)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_handles"] = [None] * len(self.shards)
        return state

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self.read(i)

    @staticmethod
    def _decode(rec: Dict[str, np.ndarray], shard: str
                ) -> Dict[str, np.ndarray]:
        out = {}
        for k, v in rec.items():
            if k.endswith("/jpeg"):
                out[k[:-5]] = jpeg.decode(v.tobytes(), f"{shard}:{k}")
            else:
                out[k] = v
        return out


def _glob_prefix(prefix: str) -> List[str]:
    # only the writer's exact '<prefix>-NNNNN.rec/.idx' names: a bare
    # startswith would also take sibling datasets like '<prefix>-aug-00000.rec'
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    pat = re.compile(re.escape(base) + r"-\d{5}\.(rec|idx)$")
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if pat.match(f)]


def offline_variants(image: np.ndarray, rects, labels,
                     rng: np.random.Generator):
    """The reference's offline augmentation chain (create_training_lmdb.py
    :296-356 ``random_argumentation``): per sample [original, flip,
    flip + anchored zoom-crop, blurred crop].  The crop window is anchored at
    the first rect's centre with random enlarge factors 2..max(3,
    floor(imgdim / rectdim)); the blur is a random odd 3..7 Gaussian of the
    crop.  Every rect rides each transform; boxes whose corner leaves the
    crop are dropped.  The draws from ``rng`` are tpufcn's, in its order."""
    labels = [int(l) for l in labels]
    out = [(image, [list(map(int, r)) for r in rects], labels)]

    flip_flag = int(rng.integers(-1, 2))
    img_f, rects_f = flip_image_with_rects(image.copy(), rects, flip_flag)
    out.append((img_f, rects_f, labels))

    ax, ay, aw, ah = [int(v) for v in rects_f[0]]
    sx = max(int(image.shape[1] / max(aw, 1)), 3)
    sy = max(int(image.shape[0] / max(ah, 1)), 3)
    e1 = int(rng.integers(2, sx + 1))
    e2 = int(rng.integers(2, sy + 1))
    x = max((ax + aw // 2) - aw * e1, 0)
    y = max((ay + ah // 2) - ah * e1, 0)
    w = aw * e1 + aw * e2
    h = ah * e1 + ah * e2
    crop = img_f[y:y + h, x:x + w].copy()
    crop_rects, crop_labels = [], []
    for (rx, ry, rw, rh), lab in zip(rects_f, labels):
        nx, ny = int(rx - x), int(ry - y)
        if 0 <= nx < crop.shape[1] and 0 <= ny < crop.shape[0]:
            crop_rects.append([nx, ny, int(rw), int(rh)])
            crop_labels.append(lab)
    if crop.size and crop_rects:
        out.append((crop, crop_rects, crop_labels))
        kx = int(rng.integers(3, 8)) | 1
        ky = int(rng.integers(3, 8)) | 1
        out.append((gaussian_blur_u8(crop, (kx, ky)), crop_rects,
                    crop_labels))
    return out


def create_detection_records(manifest_samples, out_prefix: str,
                             imread=imread_or_none,
                             shuffle_seed: Optional[int] = 0,
                             augment: bool = False,
                             relabel_contiguous: bool = False,
                             add_background: bool = False) -> int:
    """Offline dataset build (the reference's CreateTrainingLMDB): one record
    of box and label arrays per sample, the image stored as JPEG; samples
    whose image ``imread`` cannot read (None) are skipped.  ``augment``
    bakes ``offline_variants`` into the shards.

    ``relabel_contiguous`` maps the manifest's label values to 0..K-1 in
    their sorted order; ``add_background`` shifts them by 1 so that id 0 is
    a learned background class (the reference writer's np.unique and
    use_bkgnd).  The map is written beside the shards as
    ``<out_prefix>.labelmap.json`` ({"map": {original: stored},
    "add_background": bool}), which ``RecordTrainPipeline`` reads to
    un-shift stored labels.  Returns the number of records written."""
    samples = list(manifest_samples)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(samples)
    rng = np.random.default_rng(shuffle_seed or 0)

    remap = None
    if relabel_contiguous or add_background:
        uniq = sorted({int(l) for s in samples for l in s.labels})
        off = 1 if add_background else 0
        remap = {orig: i + off for i, orig in enumerate(uniq)}
        os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
        with open(out_prefix + ".labelmap.json", "w") as f:
            json.dump({"map": {str(k): v for k, v in remap.items()},
                       "add_background": bool(add_background)}, f)

    def _labels(ls):
        if remap is None:
            return np.asarray(ls, np.int32)
        return np.asarray([remap[int(l)] for l in ls], np.int32)

    n = 0
    with RecordWriter(out_prefix) as w:
        for s in samples:
            img = imread(s.image_path)
            if img is None:
                continue
            if augment:
                for vimg, vrects, vlabels in offline_variants(
                        img, s.rects, s.labels, rng):
                    w.write_image_record(vimg, {
                        "rects": np.asarray(vrects, np.int32),
                        "labels": _labels(vlabels),
                    })
                    n += 1
            else:
                w.write_image_record(img, {
                    "rects": np.asarray(s.rects, np.int32),
                    "labels": _labels(s.labels),
                })
                n += 1
    return n


def read_records(prefix: str, limit: int = 10):
    """The first ``limit`` records, decoded (the reference's ``read_lmdb``
    inspector, create_training_lmdb.py:492-509)."""
    r = RecordReader(prefix)
    out = [r.read(i) for i in range(min(limit, len(r)))]
    r.close()
    return out
