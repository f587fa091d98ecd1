"""Batch sources of the port (``tpufcn/data/pipeline.py``): fixed-capacity
box padding, batches composed on the host (``CompositeTrainPipeline``) or
read from record shards, the device batch cache and a prefetching thread.

The JAX package's cache stacks N batches and its Trainer scans them in one
dispatch.  The port's Trainer runs one step per batch, so its cache moves N
batches to the device once and yields them in turn, forever: the same
sequence of steps.
"""

from __future__ import annotations

import functools
import json
import os
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from torchfcn.core.config import DataConfig, GridConfig
from torchfcn.data.compositor import (
    Compositor, random_augmentation, resize_image_and_rects)
from torchfcn.data.imageio import imread_or_none
from torchfcn.data.manifest import MaskSample
from torchfcn.data.raster import resize_linear_u8, resize_nearest_u8
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


class CompositeTrainPipeline:
    """Scenes composed on the host for detection training
    (``tpufcn/data/pipeline.py``): each scene a random half-crop of a
    background with ``num_compose`` objects pasted (``Compositor``), then
    ``random_augmentation`` and the cubic resize to the grid's size.
    Yields host batches {image uint8 (B, H, W, 3), rects, labels, valid,
    seg int32 (B, H, W)}.  ``imread`` decodes both the samples' files and
    the backgrounds (default ``imageio.imread_or_none``); backgrounds are
    decoded once."""

    def __init__(self,
                 samples: Sequence[MaskSample],
                 grid: GridConfig,
                 data_cfg: Optional[DataConfig] = None,
                 backgrounds: Optional[Sequence[str]] = None,
                 box_capacity: int = 8,
                 imread=imread_or_none,
                 seed: int = 0):
        self.cfg = data_cfg or DataConfig()
        self.grid = grid
        self.box_capacity = box_capacity
        # the reference reads the background again every iteration
        # (data_argumentation_layer.py:86); consumers only read it (the
        # compositor copies before pasting)
        self.imread = functools.lru_cache(maxsize=64)(lambda p: imread(p))
        self.samples = list(samples)
        self.backgrounds = list(backgrounds or [])
        self.compositor = Compositor(
            self.samples,
            iou_thresh=self.cfg.compose_iou_thresh,
            max_trials=self.cfg.compose_max_trials,
            scale_range=self.cfg.scale_range,
            imread=imread)
        self.rng = np.random.default_rng(seed)

    def _background(self) -> np.ndarray:
        """Random half-crop of a background frame (reference
        data_argumentation_layer.py:86-96); a dataset image when no
        backgrounds are configured."""
        rng = self.rng
        if self.backgrounds:
            path = self.backgrounds[int(rng.integers(
                0, len(self.backgrounds)))]
        else:
            s = self.samples[int(rng.integers(0, len(self.samples)))]
            path = s.image_path
        img = self.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        h, w = img.shape[0] // 2, img.shape[1] // 2
        x = int(rng.integers(0, max(w, 1)))
        y = int(rng.integers(0, max(h, 1)))
        x = min(x, img.shape[1] - w)
        y = min(y, img.shape[0] - h)
        return img[y:y + h, x:x + w]

    def sample_scene(self):
        bg = self._background()
        num = int(self.rng.integers(self.cfg.num_compose[0],
                                    self.cfg.num_compose[1] + 1))
        scene = self.compositor.compose(num, bg, self.rng)
        img, rects, label_map = random_augmentation(
            scene.image, [list(r) for r in scene.rects], self.rng,
            label_map=scene.mask,
            enable_zoom=len(scene.rects) == 1,
            rotate=self.cfg.rotate)
        img, rects = resize_image_and_rects(
            img, rects, (self.grid.im_width, self.grid.im_height))
        if label_map is None:
            label_map = np.zeros(img.shape[:2], np.uint8)
        seg = resize_nearest_u8(label_map,
                                (self.grid.im_width, self.grid.im_height))
        return img, rects, scene.labels[:len(rects)], seg

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        H, W = self.grid.im_height, self.grid.im_width
        images = np.zeros((batch_size, H, W, 3), np.uint8)
        rects = np.zeros((batch_size, self.box_capacity, 4), np.float32)
        labels = np.zeros((batch_size, self.box_capacity), np.int32)
        valid = np.zeros((batch_size, self.box_capacity), bool)
        seg = np.zeros((batch_size, H, W), np.int32)
        for i in range(batch_size):
            img, r, l, m = self.sample_scene()
            images[i] = img
            rects[i], labels[i], valid[i] = pad_boxes(r, l, self.box_capacity)
            seg[i] = m
        return {"image": images, "rects": rects, "labels": labels,
                "valid": valid, "seg": seg}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch(self.cfg.batch_size)


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
