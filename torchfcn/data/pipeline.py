"""Batch sources of the port (``tpufcn/data/pipeline.py``): fixed-capacity
box padding, the device batch cache and a prefetching thread.

The JAX package's cache stacks N batches and its Trainer scans them in one
dispatch.  The port's Trainer runs one step per batch, so its cache moves N
batches to the device once and yields them in turn, forever: the same
sequence of steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


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
