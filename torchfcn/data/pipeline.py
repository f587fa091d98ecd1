"""Batch sources of the port (``tpufcn/data/pipeline.py``): fixed-capacity
box padding, batches read from record shards, the device batch cache and a
prefetching thread.

The JAX package's cache stacks N batches and its Trainer scans them in one
dispatch.  The port's Trainer runs one step per batch, so its cache moves N
batches to the device once and yields them in turn, forever: the same
sequence of steps.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from torchfcn.core.config import GridConfig
from torchfcn.data.raster import resize_linear_u8
from torchfcn.data.records import RecordReader


def pad_boxes(rects, labels, capacity: int):
    """Fixed-capacity (rects, labels, valid) padding for static shapes."""
    m = len(rects)
    out_r = np.zeros((capacity, 4), np.float32)
    out_l = np.zeros((capacity,), np.int32)
    out_v = np.zeros((capacity,), bool)
    k = min(m, capacity)
    if k:
        out_r[:k] = np.asarray(rects, np.float32)[:k]
        out_l[:k] = np.asarray(labels, np.int32)[:k]
        out_v[:k] = True
    return out_r, out_l, out_v


class RecordTrainPipeline:
    """Batches read from record shards (no compositing): host dicts of numpy
    {image u8 (B, H, W, 3), rects, labels, valid}, each record's image
    resized to the grid's size (``resize_linear_u8``, cv2's INTER_LINEAR)
    and its rects scaled with it.  Records come in the order of
    permutations drawn from ``np.random.default_rng(seed)``, a new one at
    each pass, as tpufcn's pipeline draws them.

    Shards written with ``add_background`` store 1-based ids (their
    ``.labelmap.json`` says so); the batches carry 0-based object ids, since
    the train step applies any background shift itself, so stored labels
    are shifted back here."""

    def __init__(self, prefix: str, grid: GridConfig,
                 batch_size: int = 32, box_capacity: int = 8, seed: int = 0):
        self.reader = RecordReader(prefix)
        self.grid = grid
        self.batch_size = batch_size
        self.box_capacity = box_capacity
        self.rng = np.random.default_rng(seed)
        self._label_base = 0
        sidecar = prefix + ".labelmap.json"
        if os.path.isfile(sidecar):
            with open(sidecar) as f:
                meta = json.load(f)
            if isinstance(meta, dict) and meta.get("add_background"):
                self._label_base = 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        H, W = self.grid.im_height, self.grid.im_width
        order = self.rng.permutation(len(self.reader))
        pos = 0
        while True:
            images = np.zeros((self.batch_size, H, W, 3), np.uint8)
            rects = np.zeros((self.batch_size, self.box_capacity, 4),
                             np.float32)
            labels = np.zeros((self.batch_size, self.box_capacity), np.int32)
            valid = np.zeros((self.batch_size, self.box_capacity), bool)
            for i in range(self.batch_size):
                if pos >= len(order):
                    order = self.rng.permutation(len(self.reader))
                    pos = 0
                rec = self.reader.read(int(order[pos]))
                pos += 1
                img = rec["image"]
                r = rec["rects"].astype(np.float32)
                sy, sx = H / img.shape[0], W / img.shape[1]
                r = r * np.array([sx, sy, sx, sy], np.float32)
                images[i] = resize_linear_u8(img, (W, H))
                rects[i], labels[i], valid[i] = pad_boxes(
                    r, rec["labels"] - self._label_base, self.box_capacity)
            yield {"image": images, "rects": rects, "labels": labels,
                   "valid": valid}


class DeviceBatchCache:
    """Device-resident epoch cache: ``put`` (e.g. ``Trainer.put``) the first
    ``n_batches`` batches of ``source`` once, then yield them in turn,
    forever.  A batch that is already on the device (the device compositor's)
    is not copied; ``Trainer.put`` drops "seg" unless it trains the seg
    head, and on a mesh keeps the rank's share (a ``LocalBatch``, which
    ``fit`` does not shard again)."""

    def __init__(self, put: Callable[[Dict], Dict], source: Iterator[Dict],
                 n_batches: int):
        if n_batches < 1:
            raise ValueError(f"n_batches must be at least 1, got {n_batches}")
        self.batches = [put(next(source)) for _ in range(n_batches)]

    def __iter__(self):
        while True:
            yield from self.batches


def prefetch(source: Iterator, depth: int = 2,
             transform: Optional[Callable] = None) -> Iterator:
    """Run ``source`` in a daemon thread with a bounded queue.

    ``transform`` (e.g. a copy to the device) is applied on the consumer
    side, so the transfer overlaps the next batch's build.  An error in the
    source is raised to the consumer; when the consumer stops, the worker
    stops at its next put.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def _put(item) -> bool:
        # bounded put that keeps observing ``stop`` (a plain q.put on a
        # full queue never wakes once the consumer exits)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in source:
                if stop.is_set():
                    return
                if not _put(item):
                    return
        except BaseException as e:   # propagate, don't fake end-of-data
            _put(e)
        else:
            _put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield transform(item) if transform else item
    finally:
        stop.set()
