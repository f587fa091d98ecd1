"""The port's stream surface (``torchfcn/serve/stream.py``) against
tpufcn's (``tpufcn/serve/stream.py``) on the same frames and weights.

* ``DetectorNode`` with real Detectors: vgg_detectnet_train at 64x64,
  stride 8, 11 classes, float32 (the port under ``DTypePolicy.parity()``),
  tpufcn's seeded weights carried over with ``load_jax_params``, the heads
  biased as in ``tests/test_torch_family_detector.py`` so that NMS gets
  clusters.  Every published ``RectsMsg``: stamps, corner points and
  labels equal, confidences within 1 ulp (XLA's CPU float32 log).  Single-
  frame and micro-batched replays, and ``replay_throughput``'s count.
* The node's micro-batching semantics with the same stub detector on
  both packages' nodes (the cases of ``tests/test_bus_stream.py``): the
  stub's call shapes, the published stamps and ``processed`` equal; the
  overlay topic's images equal tpufcn's node's under the same stamps.
* ``TiledSegmenter`` (fcn32s_seg, 224x224 tiles, float32): the pmap equal
  to tpufcn's (which resizes and finds contours with cv2) but at a share
  of values off by one, bounded by ``PMAP_OFF_BY_ONE``: the score maps
  agree to about 1e-6, and ``(feat * 255)`` truncates, so a product within
  that of an integer may land on either side; the boxes equal.
* ``largest_contour_rect`` against cv2 on 600 random masks (blobs, rings,
  lines, single pixels, holes), and ``resize_linear_f32`` against
  ``cv.resize``.
"""

import time

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufcn.core.config import DetectorConfig as JDetectorConfig
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.serve import bus as jbus
from tpufcn.serve import detector as jax_det
from tpufcn.serve import stream as jstream
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DetectorConfig, GridConfig
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.data.raster import largest_contour_rect, resize_linear_f32
from torchfcn.serve import bus as tbus
from torchfcn.serve import stream as tstream
from torchfcn.serve.detector import Detector

torch.set_num_threads(2)

NAME, HW, STRIDE, CLASSES = "vgg_detectnet_train", 64, 8, 11
BOX = np.float32([-24, -24, 120, 120])
# the share of pmap values allowed to differ by one from tpufcn's
PMAP_OFF_BY_ONE = 1e-3
# resize_linear_f32 on 3 channels: the share of values off cv2's (read
# 1.66 % at most over the test's 100 images)
RESIZE_3CH_SHARE = 0.02
RECTS = "/fcn_object_detector/rects"


@pytest.fixture(scope="module")
def detectors():
    jdet = jax_det.Detector(NAME, dtype=jnp.float32, config=JDetectorConfig(
        grid=JGridConfig(HW, HW, stride=STRIDE, num_classes=CLASSES),
        model=NAME), rng_seed=0)
    params = jax.tree.map(np.array, jdet.params)
    params["params"]["cvg/classifier"]["conv"]["bias"][:] = 1.0
    params["params"]["bbox/regressor"]["conv"]["bias"][:] = np.tile(
        BOX, CLASSES)
    jdet.params = jax.tree.map(jnp.asarray, params)
    det = Detector(NAME, device="cpu", policy=DTypePolicy.parity(),
                   config=DetectorConfig(
                       grid=GridConfig(HW, HW, stride=STRIDE,
                                       num_classes=CLASSES), model=NAME))
    load_jax_params(det.model, params)
    return jdet, det


def _frames(n, seed=0, hw=(HW, HW)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for _ in range(n)]


def _replay(pkg_bus, pkg_stream, det, frames, **node_kw):
    bus = pkg_bus.TopicBus()
    node = pkg_stream.DetectorNode(bus, detector=det, **node_kw)
    out = []
    bus.subscribe(RECTS, lambda m: out.append((m.stamp, m.data)),
                  queue_size=10 ** 6)
    n = pkg_stream.replay(node, frames)
    bus.spin_once()
    return n, out, node


def _assert_same_rects(got, want):
    assert len(got) == len(want)
    n_dets = 0
    for (gs, g), (ws, w) in zip(got, want):
        assert gs == ws
        assert [list(p) for p in g.points] == [list(p) for p in w.points]
        assert g.labels == w.labels
        np.testing.assert_array_max_ulp(np.float32(g.confidences),
                                        np.float32(w.confidences), 1)
        n_dets += len(g.labels)
    assert n_dets > 0


@pytest.mark.parametrize("micro_batch", [1, 2])
def test_detector_node_replay_matches_jax(detectors, micro_batch):
    """5 frames: single-frame mode, and micro-batches of 2 with a padded
    tail; the same rects with the original stamps in order."""
    jdet, det = detectors
    frames = _frames(5)
    jn, jout, _ = _replay(jbus, jstream, jdet, frames,
                          micro_batch=micro_batch)
    n, out, node = _replay(tbus, tstream, det, frames,
                           micro_batch=micro_batch)
    assert n == jn == 5
    assert [s for s, _ in out] == [0.0, 1.0, 2.0, 3.0, 4.0]
    _assert_same_rects(out, jout)
    stats = node.latency_stats()
    assert stats["frames"] == 5
    assert set(stats) == {"frames", "p50_ms", "p90_ms", "p99_ms", "max_ms"}


def test_replay_throughput_counts_tail(detectors):
    """3 frames at micro-batch 2 count 3 (the tail padded, not counted
    twice), 1 frame counts 1, on both packages."""
    jdet, det = detectors
    frames = _frames(3, seed=1)
    for pkg, d in ((jstream, jdet), (tstream, det)):
        out = pkg.replay_throughput(d, frames, micro_batch=2)
        assert out["frames"] == 3 and out["fps"] > 0
        assert set(out) == {"frames", "seconds", "fps", "ms_per_frame"}
        assert pkg.replay_throughput(d, frames[:1], micro_batch=2)[
            "frames"] == 1


class _Res:
    def __init__(self, n):
        self.n = n

    def to_lists(self):
        return [[([1, 2, 3, 4], 0, 0.9)]] * self.n


class _Stub:
    """A detector that records its call shapes and can fail once."""

    def __init__(self, fail_first=False):
        self.calls = []
        self.fail_first = fail_first

    def __call__(self, frames):
        self.calls.append(frames.shape)
        if self.fail_first and len(self.calls) == 1:
            raise RuntimeError("device dispatch failed")
        return _Res(frames.shape[0])


def _stub_run(pkg_bus, pkg_stream, script, **node_kw):
    """Run ``script(bus, node)`` on a node with a stub detector; returns
    (stub calls, published stamps, processed, latency frames)."""
    bus = pkg_bus.TopicBus()
    stub = _Stub(node_kw.pop("fail_first", False))
    node = pkg_stream.DetectorNode(bus, detector=stub, **node_kw)
    out = []
    bus.subscribe(RECTS, lambda m: out.append(m.stamp), queue_size=64)
    script(bus, node)
    bus.spin_once()
    return stub.calls, out, node.processed, \
        node.latency_stats()["frames"]


def _both_stub(script, **node_kw):
    got = _stub_run(tbus, tstream, script, **dict(node_kw))
    want = _stub_run(jbus, jstream, script, **dict(node_kw))
    assert got == want
    return got


def test_micro_batching_pads_the_tail_and_flushes_on_geometry():
    frames = _frames(5, hw=(32, 48))
    other = _frames(2, hw=(40, 48))

    def script(bus, node):
        for i, f in enumerate(frames[:3] + other + frames[3:]):
            bus.publish("image", f, stamp=float(i))
            bus.spin_once()
        node.flush()
        assert node.flush() is None      # idempotent

    calls, stamps, processed, lat = _both_stub(script, micro_batch=2)
    # (0, 1) full; 2 padded when frame 3 changes the geometry; (3, 4) at
    # the new size; (5, 6) full at the old one
    assert calls == [(2, 32, 48, 3), (2, 32, 48, 3), (2, 40, 48, 3),
                     (2, 32, 48, 3)]
    assert stamps == [float(i) for i in range(7)]
    assert processed == lat == 7


def test_failed_dispatch_keeps_frames():
    frames = _frames(3, hw=(32, 48))

    def script(bus, node):
        bus.publish("image", frames[0], stamp=0.0)
        bus.publish("image", frames[1], stamp=1.0)
        with pytest.raises(RuntimeError):
            bus.spin_once()
        assert node.processed == 0 and len(node._pending) == 2
        bus.publish("image", frames[2], stamp=2.0)
        bus.spin_once()      # retry: one full batch, one frame buffered
        node.flush()

    calls, stamps, processed, _ = _both_stub(script, micro_batch=2,
                                             fail_first=True)
    assert calls == [(2, 32, 48, 3)] * 3
    assert stamps == [0.0, 1.0, 2.0] and processed == 3


def test_deadline_flush_from_the_spin_hook():
    frames = _frames(2, hw=(32, 48))

    def script(bus, node):
        bus.publish("image", frames[0], stamp=0.0)
        bus.publish("image", frames[1], stamp=1.0)
        bus.spin_once()
        assert node.processed == 0          # under the deadline: buffered
        time.sleep(0.06)
        bus.spin_once()                     # no new frame: the hook flushes
        assert node.processed == 2
        assert node.latency_stats()["p50_ms"] >= 40

    calls, stamps, processed, _ = _both_stub(script, micro_batch=4,
                                             flush_after_ms=40)
    assert calls == [(4, 32, 48, 3)] and stamps == [0.0, 1.0]


def test_deadline_flush_on_arrival():
    frames = _frames(2, hw=(32, 48))

    def script(bus, node):
        bus.publish("image", frames[0], stamp=0.0)
        bus.spin_once()
        time.sleep(0.05)
        bus.publish("image", frames[1], stamp=1.0)
        bus.spin_once()
        assert node.processed == 2          # flushed when frame 1 arrived

    calls, stamps, processed, lat = _both_stub(script, micro_batch=4,
                                               flush_after_ms=30)
    assert calls == [(4, 32, 48, 3)] and processed == lat == 2


def test_node_defaults_and_unported_params():
    bus = tbus.TopicBus()
    # tiled mode builds no Detector; boxes mode builds Detector() on the
    # card, which this host lacks
    node = tstream.DetectorNode(bus, mode="tiled", tiled=object())
    assert node.detector is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tstream.DetectorNode(bus)
    # the overlay topic: tpufcn's node's images under the same stamps, from
    # a detector whose boxes cross the frame's edges, with names and without
    frames = _frames(3, hw=(60, 80))
    dets = [([-5, 10, 40, 70], 2, 0.8), ([30, -8, 95, 30], 0, 1.5),
            ([50, 20, 50, 44], 1, 0.25)]

    class Boxes:
        def __call__(self, batch):
            return self

        def to_lists(self):
            return [dets]

    overlays = {}
    for key, pkg_bus, pkg_stream in (("port", tbus, tstream),
                                     ("jax", jbus, jstream)):
        b = pkg_bus.TopicBus()
        node = pkg_stream.DetectorNode(b, detector=Boxes(),
                                       overlay_topic="/o",
                                       names=["ball", "crate"])
        got = overlays[key] = []
        b.subscribe("/o", lambda m, got=got: got.append((m.stamp, m.data)),
                    queue_size=8)
        for i, f in enumerate(frames):
            b.publish("image", f, stamp=0.5 * i)
            b.spin_once()
        b.spin_once()
        assert node.overlay_topic == "/o"
    assert [s for s, _ in overlays["port"]] == [0.0, 0.5, 1.0]
    assert [s for s, _ in overlays["port"]] == [s for s, _ in overlays["jax"]]
    for (_, a), (_, b), f in zip(overlays["port"], overlays["jax"], frames):
        assert np.array_equal(a, b) and not np.array_equal(a, f)


def test_detection_window_rois():
    img = np.zeros((480, 640, 3), np.uint8)
    for stride in (1, 2, 3):
        got = tstream.detection_window_rois(img, stride)
        want = jstream.detection_window_rois(img, stride)
        assert [r.tolist() for r in got] == [r.tolist() for r in want]


def test_tiled_segmenter_matches_jax():
    jseg = jstream.TiledSegmenter("fcn32s_seg", dtype=jnp.float32, stride=2)
    params = jax.tree.map(np.array, jseg.params)
    # lift class 1 near the threshold so that its maps hold regions
    params["params"]["score_fr_6"]["conv"]["bias"][1] = 2.6
    jseg.params = jax.tree.map(jnp.asarray, params)
    seg = tstream.TiledSegmenter("fcn32s_seg", stride=2, device="cpu",
                                 dtype=torch.float32)
    load_jax_params(seg.model, params)
    frame = np.random.default_rng(4).integers(0, 256, (120, 160, 3),
                                              dtype=np.uint8)
    frame[30:90, 40:120] //= 3                 # a darker region
    jpmap, jboxes = jseg(frame)
    pmap, boxes = seg(frame)
    assert pmap.shape == (120, 160) and pmap.dtype == np.uint8
    diff = np.abs(pmap.astype(int) - jpmap.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= PMAP_OFF_BY_ONE
    assert (jpmap > 0).mean() > 0.05            # the maps hold regions
    assert boxes == jboxes and len(boxes) > 0


def _cv_rect(m):
    im = (m > 0).astype(np.uint8) * 255
    contours, _ = cv.findContours(im, cv.RETR_CCOMP,
                                  cv.CHAIN_APPROX_SIMPLE)[-2:]
    if not contours:
        return None, 0
    areas = [cv.contourArea(c) for c in contours]
    biggest = contours[int(np.argmax(areas))]
    ties = sum(a == max(areas) for a in areas)
    if max(areas) <= 0:
        return None, ties
    return tuple(int(v) for v in cv.boundingRect(biggest)), ties


def _random_mask(rng, kind):
    h, w = rng.integers(3, 60, 2)
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), bool)
    if kind == 0:                       # noise
        m = rng.random((h, w)) < rng.uniform(0.05, 0.7)
    elif kind == 1:                     # discs
        for _ in range(rng.integers(1, 5)):
            y, x, r = rng.integers(0, h), rng.integers(0, w), \
                rng.integers(1, 8)
            m |= (yy - y) ** 2 + (xx - x) ** 2 <= r * r
    elif kind == 2:                     # rings: holes
        for _ in range(rng.integers(1, 4)):
            y, x, r = rng.integers(0, h), rng.integers(0, w), \
                rng.integers(2, 10)
            d = (yy - y) ** 2 + (xx - x) ** 2
            m |= (d <= r * r) & (d >= (r - 1) ** 2)
    elif kind == 3:                     # lines
        m[rng.integers(0, h, 3), :] = True
        if rng.random() < 0.5:
            m[:, rng.integers(0, w, 2)] = True
    else:                               # single pixels and a square
        m[rng.integers(0, h, 4), rng.integers(0, w, 4)] = True
        if rng.random() < 0.5:
            y, x = rng.integers(0, h), rng.integers(0, w)
            m[y:y + 5, x:x + 5] = True
    return m


def test_largest_contour_rect_matches_cv2():
    """600 masks: boxes equal everywhere, also where several contours share
    the largest area (counted: equal components, or a one-pixel ring's two
    borders)."""
    rng = np.random.default_rng(0)
    ties = nones = 0
    for i in range(600):
        m = _random_mask(rng, i % 5)
        want, n_max = _cv_rect(m)
        assert largest_contour_rect(m) == want, i
        ties += n_max > 1 and want is not None
        nones += want is None
    assert ties >= 10 and nones >= 10


def test_resize_linear_f32_matches_cv2():
    """One channel bit-equal; three channels within one ulp of the image's
    largest value (an unfused ``a + (b - a) * t`` against the fused one,
    IPP's lanes) at a share of at most RESIZE_3CH_SHARE of the values."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for i in range(200):
        h, w = rng.integers(5, 90, 2)
        dh, dw = rng.integers(5, 300, 2)
        c = (1, 3)[i % 2]
        img = rng.random((h, w, c), dtype=np.float32) * [1, 255][i % 4 // 2]
        want = cv.resize(img, (int(dw), int(dh)))
        got = resize_linear_f32(img, (int(dw), int(dh)))
        assert got.shape == want.shape and got.dtype == np.float32
        if c == 1:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= np.spacing(img.max())
            worst = max(worst, float((got != want).mean()))
    assert worst <= RESIZE_3CH_SHARE
    img = rng.random((64, 48), dtype=np.float32)     # an exact halving
    np.testing.assert_array_equal(resize_linear_f32(img, (24, 32)),
                                  cv.resize(img, (24, 32)))
