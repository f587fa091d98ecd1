"""Stream nodes of the port on its topic bus (``tpufcn/serve/stream.py``).

``DetectorNode`` mirrors the reference's ``FCNObjectDetector`` node: it
subscribes ``image`` (a drop-oldest queue sized to the micro-batch: 1 in
the default single-frame mode, so only the freshest frame is kept;
``micro_batch=N`` buffers N frames and runs one Detector call per batch),
runs the pipeline on the card, and publishes corner rects on
``/fcn_object_detector/rects`` and, in tiled mode, a mono8 probability map
on ``/fcn_object_detector/pmap``.

Two inference modes, as the reference's two callbacks:
  * "boxes": full-frame grid decode + NMS (``torchfcn.serve.detector``);
  * "tiled": stride^2 sub-window tiles plus a centre crop, forwarded as one
    batch through a segmentation model, the per-class score maps stitched
    into a full-frame pmap with bitwise OR, and one box per tile and class
    from the largest contour of its map (on the host, as the reference).

The host work that the JAX package does with ``cv2`` (the tiles' and score
maps' resizes, the contours) is ``torchfcn.data.raster``'s numpy: the
card's host has no ``cv2``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchfcn.core.config import IMAGENET_BGR_MEAN
from torchfcn.data.raster import largest_contour_rect, resize_linear_f32
from torchfcn.serve.bus import Message, TopicBus


@dataclasses.dataclass
class RectsMsg:
    """Polygon-of-corners message (the reference publishes PolygonStamped
    with alternating top-left / bottom-right points)."""
    points: List[Tuple[float, float]]
    labels: List[int]
    confidences: List[float]


def detection_window_rois(image: np.ndarray, stride: int = 1):
    """The reference's ``detection_window_roi``: stride^2 tiles plus a
    centre crop, as (x, y, w, h) int arrays."""
    im_y, im_x = image.shape[:2]
    w, h = im_x // stride, im_y // stride
    rects = [np.array([i * w, j * h, w, h])
             for j in range(stride) for i in range(stride)]
    cx, cy = im_x // 2 - w // 2, im_y // 2 - h // 2
    rects.append(np.array([cx, cy, w, h]))
    return rects


def _demean_host(img: np.ndarray) -> np.ndarray:
    """Demean + min-max of a frame on the host for the tiled path (the
    tiles are cropped before the resize, in the reference's order); a
    constant frame gives zeros, not NaN."""
    x = img.astype(np.float32)
    x -= np.asarray(IMAGENET_BGR_MEAN, np.float32)
    span = x.max() - x.min()
    return (x - x.min()) / (span if span > 0 else np.float32(1.0))


class TiledSegmenter:
    """The reference's ``run_detector2`` over a segmentation model of the
    zoo: tiles cropped and resized on the host, the forward on ``device``
    (default "cuda", which raises without CUDA; "cpu" runs on the CPU) in
    ``dtype`` (float32 with TF32 off), scores below ``prob_thresh`` set to
    0.  The weights are the seeded Caffe "xavier" init until loaded into
    ``.model``."""

    def __init__(self, model_name: str = "fcn32s_seg",
                 prob_thresh: float = 0.5,
                 stride: int = 1,
                 padding: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        from torchfcn.models import get_spec
        from torchfcn.serve.detector import serving_model, serving_policy
        self.spec = get_spec(model_name)
        self.grid = self.spec.grid
        self.prob_thresh = prob_thresh
        self.stride = stride
        self.padding = padding
        self.policy = serving_policy(dtype, None)
        self.model = serving_model(model_name, dtype, 0, None, device)
        self.device = torch.device(device)

    @torch.inference_mode()
    def scores(self, tiles: np.ndarray) -> np.ndarray:
        """(T, H, W, 3) float32 tiles at the net's size -> (T, h, w, C)
        float32 class scores, those below the threshold 0."""
        x = torch.as_tensor(tiles, device=self.device)
        with self.policy.precision():
            out = self.model(x)
        score = out.get("score", out.get("coverage")).float()
        score = torch.where(score < self.prob_thresh, 0.0, score)
        return score.cpu().numpy()

    def __call__(self, frame_bgr: np.ndarray):
        """Returns (pmap uint8 full-frame, [(rect, class)] boxes)."""
        img = _demean_host(frame_bgr)
        rois = detection_window_rois(img, self.stride)
        net_wh = (self.grid.im_width, self.grid.im_height)
        tiles = np.stack([resize_linear_f32(img[y:y + h, x:x + w], net_wh)
                          for x, y, w, h in rois])
        score = self.scores(tiles)

        pmap = np.zeros(frame_bgr.shape[:2], np.uint8)
        boxes = []
        pad = self.padding
        for smap, rect in zip(score, rois):
            x, y, w, h = [int(v) for v in rect]
            for cls in range(1, smap.shape[-1]):
                # resize the float map, cast after (the reference's order)
                feat = resize_linear_f32(smap[..., cls], (w, h))
                feat = (feat * 255).astype(np.uint8)
                pmap[y:y + h, x:x + w] |= feat
                r = largest_contour_rect(feat)
                if r is not None:
                    bx = [r[0] + x - pad, r[1] + y - pad,
                          r[2] + 2 * pad, r[3] + 2 * pad]
                    boxes.append((bx, cls))
        return pmap, boxes


class DetectorNode:
    """The detector stream node on a TopicBus.

    ``detector``: a ``torchfcn.serve.detector.Detector`` (by default
    ``Detector()``, on the card, built only outside tiled mode).
    ``micro_batch > 1`` buffers frames and runs one Detector call per
    micro-batch, publishing per-frame rects with their original stamps; a
    part-filled batch is padded by repeating its last frame (one batch
    shape) and the pad outputs are dropped; ``flush()`` at stream end.
    ``flush_after_ms`` bounds a buffered frame's staleness: checked when a
    frame arrives and from a bus spin hook, so a silent stream flushes too.
    ``names``: class display names from a label manifest.
    ``overlay_topic``: publish the reference's class-coloured, alpha-
    blended overlay of each frame (``torchfcn.serve.viz.draw_detections``,
    drawn on the host) under the frame's stamp.

    A ``detector`` on a mesh of several ranks (``Detector(mesh=...)``, the
    launch param ``mesh``): rank 0 leads, subscribing to the bus and
    deciding each dispatch (micro-batch full, staleness deadline, flush) as
    above; before each Detector call it broadcasts the batch to the other
    ranks, which do not subscribe and run ``follow()`` instead, calling the
    Detector with the same batch until the leader's ``close()``.  A rank's
    own clock and bus thus never decide a collective call.
    """

    def __init__(self,
                 bus: TopicBus,
                 detector: Optional[Any] = None,
                 mode: str = "boxes",
                 image_topic: str = "image",
                 rects_topic: str = "/fcn_object_detector/rects",
                 pmap_topic: str = "/fcn_object_detector/pmap",
                 tiled: Optional[TiledSegmenter] = None,
                 publish_rects: bool = True,
                 names: Optional[Sequence[str]] = None,
                 overlay_topic: Optional[str] = None,
                 micro_batch: int = 1,
                 flush_after_ms: Optional[float] = None,
                 timer=None):
        self.bus = bus
        self.mode = mode
        self.names = list(names) if names else None
        if detector is None and mode != "tiled":
            from torchfcn.serve.detector import Detector
            detector = Detector()
        self.detector = detector
        mesh = getattr(detector, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        # a rank of a mesh other than rank 0 follows the leader's batches
        self.following = self._mesh is not None and self._mesh.rank != 0
        self.tiled = tiled
        self.rects_topic = rects_topic
        self.pmap_topic = pmap_topic
        self.publish_rects = publish_rects
        self.overlay_topic = overlay_topic
        self.timer = timer   # optional torchfcn.utils.profiling.StageTimer
        self.micro_batch = max(1, int(micro_batch))
        self.flush_after_ms = flush_after_ms
        self._pending: List[Tuple[np.ndarray, float]] = []
        self._buffered_at: List[float] = []   # monotonic arrival times
        # per-frame node latency (buffer -> rects published), ms; bounded
        self.latencies_ms: deque = deque(maxlen=1024)
        self.processed = 0
        # buffer up to a full micro-batch in the subscription queue: with a
        # drop-oldest queue of 1, frames published faster than spin_once
        # would vanish before batching
        if self.following:
            return
        bus.subscribe(image_topic, self._callback,
                      queue_size=self.micro_batch)
        if self.flush_after_ms is not None and self.micro_batch > 1:
            bus.add_spin_hook(self._deadline_check)

    def _callback(self, msg: Message):
        if self.timer is not None:
            with self.timer.stage(f"detector/{self.mode}"):
                return self._process(msg)
        return self._process(msg)

    def _process(self, msg: Message):
        frame = msg.data
        if frame is None:
            return
        if self.mode == "tiled":
            assert self.tiled is not None, "tiled mode needs a TiledSegmenter"
            pmap, boxes = self.tiled(frame)
            self.bus.publish(self.pmap_topic, pmap, stamp=msg.stamp)
            if self.publish_rects:
                pts, labels = [], []
                for (x, y, w, h), cls in boxes:
                    pts += [(x, y), (x + w, y + h)]
                    labels.append(cls)
                self.bus.publish(self.rects_topic,
                                 RectsMsg(pts, labels, [0.0] * len(labels)),
                                 stamp=msg.stamp)
        elif self.micro_batch > 1:
            if self._pending and self._pending[0][0].shape != frame.shape:
                self.flush()     # camera geometry changed mid-stream
            self._pending.append((frame, msg.stamp))
            self._buffered_at.append(time.monotonic())
            if (len(self._pending) >= self.micro_batch
                    or self._deadline_exceeded()):
                self._dispatch()
            return               # processed counts at dispatch time
        else:
            t0 = time.monotonic()
            # to_lists() copies the results to the host: the clock stops
            # after the card has finished
            dets = self._detect(frame[None]).to_lists()[0]
            self._publish_boxes(frame, dets, msg.stamp)
            self.latencies_ms.append((time.monotonic() - t0) * 1e3)
        self.processed += 1

    def _deadline_exceeded(self) -> bool:
        return bool(self.flush_after_ms is not None and self._buffered_at
                    and (time.monotonic() - self._buffered_at[0]) * 1e3
                    >= self.flush_after_ms)

    def _deadline_check(self):
        """Bus spin hook: flush a part-filled micro-batch whose oldest frame
        is staler than ``flush_after_ms`` even when no new frame arrives."""
        if self._pending and self._deadline_exceeded():
            self._dispatch()

    def latency_stats(self) -> dict:
        """Per-frame node latency percentiles (buffer -> rects published),
        over the last 1024 frames at most."""
        if not self.latencies_ms:
            return {"frames": 0}
        v = np.asarray(self.latencies_ms)
        return {"frames": int(v.size),
                "p50_ms": float(np.percentile(v, 50)),
                "p90_ms": float(np.percentile(v, 90)),
                "p99_ms": float(np.percentile(v, 99)),
                "max_ms": float(v.max())}

    def _publish_boxes(self, frame, dets, stamp: float):
        if self.publish_rects:
            pts = [p for box, _, _ in dets
                   for p in ((box[0], box[1]), (box[2], box[3]))]
            labels = [l for _, l, _ in dets]
            confs = [c for _, _, c in dets]
            self.bus.publish(self.rects_topic,
                             RectsMsg(pts, labels, confs), stamp=stamp)
        if self.overlay_topic:
            from torchfcn.serve.viz import draw_detections
            self.bus.publish(self.overlay_topic,
                             draw_detections(frame, dets, self.names),
                             stamp=stamp)

    def _dispatch(self):
        # chunk at micro_batch: after a failed dispatch restores its frames,
        # _pending can exceed one batch; never stack a larger shape
        while self._pending:
            pending = self._pending[:self.micro_batch]
            self._pending = self._pending[self.micro_batch:]
            buffered = self._buffered_at[:self.micro_batch]
            self._buffered_at = self._buffered_at[self.micro_batch:]
            n = len(pending)
            stack = np.stack([f for f, _ in pending])
            if n < self.micro_batch:
                # pad to the one batch shape; the pad outputs are dropped
                stack = np.concatenate(
                    [stack, np.repeat(stack[-1:], self.micro_batch - n,
                                      axis=0)])
            try:
                lists = self._detect(stack).to_lists()
            except Exception:
                # a failed dispatch must not eat the buffered frames: put
                # them back so that a later dispatch or flush retries
                self._pending = pending + self._pending
                self._buffered_at = buffered + self._buffered_at
                raise
            done = time.monotonic()
            for (frame, stamp), dets, t0 in zip(pending, lists[:n],
                                                buffered):
                self._publish_boxes(frame, dets, stamp)
                self.latencies_ms.append((done - t0) * 1e3)
            self.processed += n

    def flush(self):
        """Dispatch a buffered partial micro-batch (call at stream end)."""
        if self._pending:
            self._dispatch()

    # --- a mesh: rank 0 leads, the other ranks follow ---
    _DTYPES = (torch.uint8, torch.float32)     # the frame types sent

    def _announce(self, frames: Optional[np.ndarray]) -> None:
        """Rank 0: the next batch (None: the end) to every other rank."""
        import torch.distributed as dist
        dev = self._mesh.device
        head = torch.zeros(5, dtype=torch.int64)    # type code, B, H, W, C
        if frames is not None:
            frames = torch.as_tensor(frames)
            head[0] = self._DTYPES.index(frames.dtype) + 1
            head[1:] = torch.tensor(frames.shape)
        dist.broadcast(head.to(dev), src=0, group=self._mesh.group)
        if frames is not None:
            dist.broadcast(frames.to(dev), src=0, group=self._mesh.group)

    def _detect(self, frames: np.ndarray):
        if self._mesh is not None:
            self._announce(np.ascontiguousarray(frames))
        return self.detector(frames)

    def follow(self) -> int:
        """A following rank: run the Detector on each batch rank 0 sends
        until its ``close()``; returns the frames run."""
        import torch.distributed as dist
        dev, group = self._mesh.device, self._mesh.group
        frames_run = 0
        while True:
            head = torch.zeros(5, dtype=torch.int64, device=dev)
            dist.broadcast(head, src=0, group=group)
            code, shape = int(head[0]), [int(v) for v in head[1:]]
            if code == 0:
                return frames_run
            frames = torch.empty(shape, dtype=self._DTYPES[code - 1],
                                 device=dev)
            dist.broadcast(frames, src=0, group=group)
            self.detector(frames)
            frames_run += shape[0]

    def close(self) -> None:
        """End of the stream: flush; rank 0 of a mesh then releases the
        following ranks."""
        if self.following:
            return
        self.flush()
        if self._mesh is not None:
            self._announce(None)


def replay(node: DetectorNode, frames: Sequence[np.ndarray],
           bus: Optional[TopicBus] = None,
           image_topic: str = "image") -> int:
    """Bag replay: publish frames through the bus, stamped 0, 1, ...,
    and spin the node after each; flushes a part-filled micro-batch at the
    end.  Returns the frames the node processed."""
    bus = bus or node.bus
    for i, f in enumerate(frames):
        bus.publish(image_topic, f, stamp=float(i))
        bus.spin_once()
    node.flush()
    return node.processed


def replay_throughput(detector, frames: Sequence[np.ndarray],
                      micro_batch: int = 32) -> dict:
    """Batched stream throughput: frames from host memory grouped into
    micro-batches through the Detector, the tail padded by repeating the
    last frame and not counted.  Each batch's results are copied to the
    host before the next batch starts, so the clock covers the card's work,
    not only its launches.  Returns frames, seconds, fps and ms per
    frame."""
    n = len(frames)
    stack = np.stack(frames)
    micro_batch = min(micro_batch, n)
    pad = (-n) % micro_batch
    if pad:
        stack = np.concatenate([stack, np.repeat(stack[-1:], pad, axis=0)])
    _ = detector(stack[:micro_batch]).valid.cpu()       # warm-up
    t0 = time.perf_counter()
    results = 0
    for i in range(0, len(stack), micro_batch):
        res = [t.cpu() for t in detector(stack[i:i + micro_batch])]
        results += min(res[2].shape[0], n - i)    # padding frames not counted
    dt = time.perf_counter() - t0
    return {"frames": results, "seconds": dt,
            "fps": results / dt if dt > 0 else 0.0,
            "ms_per_frame": dt / max(results, 1) * 1e3}
