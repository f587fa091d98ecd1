"""The port's label tools (``torchfcn/tools``) against tpufcn's on the CPU,
and its template matching against cv2's.

Both packages' extractors hold the same weights: tpufcn's seeded VGG16
parameters carried across by ``CnnCodeExtractor.from_jax``, at
``input_size=64`` in float32.  On the same crops the codes agree within
1e-5 (crops resized up, down and by an exact halving, which cv2 computes
as an area average); ``match_template_ccoeff_normed`` is within 1e-5 of
``cv.matchTemplate(..., TM_CCOEFF_NORMED)``, flat windows and flat
templates included, with the same maximum where the template has texture;
and what the tools write or publish equals tpufcn's: tracked rects,
refined manifests (offline and live), the ROI classifier's results with
the random and the fitted head, and the capture node's JPEG bytes,
manifest and resumed numbering.  No module of the port imports JAX,
tpufcn, cv2 or scikit-learn.
"""

import glob
import os
import re

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufcn.data.manifest import DetectionSample as JDetectionSample
from tpufcn.serve.bus import TopicBus as JTopicBus
from tpufcn.tools import (
    BoundaryRefiner as JBoundaryRefiner,
    CnnCodeExtractor as JCnnCodeExtractor,
    ImageRectWriter as JImageRectWriter,
    ROIClassifier as JROIClassifier,
    ROIClassifierNode as JROIClassifierNode)
from tpufcn.tools.boundary_refinement import ncc_track as jncc_track
from tpufcn.tools.features import (
    bhattacharyya as jbhattacharyya, chi_square as jchi_square)
from torchfcn.data.manifest import DetectionSample
from torchfcn.serve.bus import TopicBus
from torchfcn.serve.stream import RectsMsg
from torchfcn.tools import (
    BoundaryRefiner, CnnCodeExtractor, ImageRectWriter, ROIClassifier,
    ROIClassifierNode)
from torchfcn.tools.boundary_refinement import ncc_track
from torchfcn.tools.features import bhattacharyya, chi_square
from torchfcn.tools.ncc import match_template_ccoeff_normed, min_max_loc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
CODE_ATOL = 1e-5
NCC_ATOL = 1e-5


@pytest.fixture(scope="module")
def extractors():
    """(tpufcn's extractor, the port's with the same weights)."""
    jext = JCnnCodeExtractor(input_size=SIZE, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jext.params)
    return jext, CnnCodeExtractor.from_jax(params, input_size=SIZE,
                                           dtype=torch.float32, device="cpu")


def scene(rng, ox, oy, hw=(120, 160)):
    """Noise with a textured 40 x 30 object at (ox, oy), as
    ``tests/test_tools_eval.py::_scene`` draws it."""
    img = rng.integers(0, 60, hw + (3,)).astype(np.uint8)
    gy, gx = np.mgrid[0:40, 0:30]
    img[oy:oy + 40, ox:ox + 30] = np.stack(
        [30 + gx * 4, 200 - gy * 3, 120 + ((gx + gy) % 7) * 10],
        axis=-1).clip(0, 255).astype(np.uint8)
    return img


def test_codes_match_tpufcn(extractors):
    jext, ext = extractors
    rng = np.random.default_rng(0)
    # up-scaled, down-scaled, an exact halving, a stretch of each axis, and
    # the object of a scene
    crops = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
             for hw in [(30, 40), (100, 90), (128, 128), (17, 200),
                        (64, 64)]]
    crops.append(scene(rng, 40, 30)[28:72, 38:72])
    got, want = ext(crops), jext(crops)
    assert got.shape == want.shape == (len(crops), 512)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=CODE_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    # a batch is the crops given: one crop alone has the same code
    np.testing.assert_allclose(ext(crops[2:3])[0], got[2], rtol=0,
                               atol=CODE_ATOL)


def test_caffemodel_codes_match_tpufcn(tmp_path):
    """The same VGG16 ``.caffemodel`` through both packages'
    ``from_caffemodel``: codes within 1e-5."""
    from torchfcn.convert import export_caffemodel
    from torchfcn.models.vgg import VGG16Backbone
    model = VGG16Backbone()
    model.init_weights(torch.Generator().manual_seed(5))
    path = str(tmp_path / "vgg16.caffemodel")
    export_caffemodel(model, path)
    rng = np.random.default_rng(1)
    crops = [rng.integers(0, 256, (48, 70, 3), dtype=np.uint8)
             for _ in range(3)]
    got = CnnCodeExtractor.from_caffemodel(path, input_size=SIZE,
                                           dtype=torch.float32,
                                           device="cpu")(crops)
    want = JCnnCodeExtractor.from_caffemodel(path, input_size=SIZE,
                                             dtype=jnp.float32)(crops)
    np.testing.assert_allclose(got, want, rtol=0, atol=CODE_ATOL)


def test_extractor_seeded_init_and_device(caplog):
    crops = [np.random.default_rng(2).integers(0, 256, (40, 40, 3),
                                               dtype=np.uint8)]
    kw = dict(input_size=32, dtype=torch.float32, device="cpu")
    a = CnnCodeExtractor(**kw)(crops)
    b = CnnCodeExtractor(generator=torch.Generator().manual_seed(0),
                         **kw)(crops)
    c = CnnCodeExtractor(generator=torch.Generator().manual_seed(1),
                         **kw)(crops)
    assert np.array_equal(a, b) and not np.allclose(a, c)
    assert "randomly initialized" in caplog.text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CnnCodeExtractor(input_size=32)


def test_distances_match_tpufcn():
    rng = np.random.default_rng(3)
    pairs = [(rng.random(512), rng.random(512)),
             (rng.normal(size=64), rng.normal(size=64)),
             (np.zeros(8), rng.random(8)),
             (np.zeros(8), np.zeros(8))]
    for a, b in pairs:
        assert bhattacharyya(a, b) == jbhattacharyya(a, b)
        assert chi_square(a, b) == jchi_square(a, b)


def _ncc_case(kind, rng):
    """(image, template, whether the template has texture)."""
    h, w = int(rng.integers(24, 90)), int(rng.integers(24, 90))
    th, tw = int(rng.integers(4, h // 2)), int(rng.integers(4, w // 2))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat_windows":
        img[:h // 2] = 17
    elif kind == "posterised":
        img = img // 64 * 64
    y, x = int(rng.integers(0, h - th + 1)), int(rng.integers(0, w - tw + 1))
    tmpl = img[y:y + th, x:x + tw].copy()
    if kind == "flat_template":
        tmpl[:] = 100
    if kind == "gray":
        img, tmpl = img[..., 0], tmpl[..., 0]
    return img, tmpl, kind != "flat_template" and tmpl.std() > 0


@pytest.mark.parametrize("kind", ["color", "gray", "flat_windows",
                                  "posterised", "flat_template"])
def test_match_template_matches_cv2(kind):
    rng = np.random.default_rng(["color", "gray", "flat_windows",
                                 "posterised", "flat_template"].index(kind))
    for _ in range(40):
        img, tmpl, textured = _ncc_case(kind, rng)
        want = cv.matchTemplate(img, tmpl, cv.TM_CCOEFF_NORMED)
        got = match_template_ccoeff_normed(img, tmpl)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=NCC_ATOL)
        if textured:
            assert min_max_loc(got)[3] == cv.minMaxLoc(want)[3]


def test_min_max_loc_first_in_row_major():
    a = np.zeros((4, 5), np.float32)
    a[2, 1] = a[1, 3] = 2.0
    a[3, 0] = a[0, 4] = -1.0
    assert min_max_loc(a) == cv.minMaxLoc(a) == (-1.0, 2.0, (4, 0), (3, 1))


def test_ncc_track_matches_tpufcn():
    rng = np.random.default_rng(4)
    n = 0
    for _ in range(30):
        ox, oy = int(rng.integers(5, 120)), int(rng.integers(5, 70))
        dx, dy = (int(v) for v in rng.integers(-8, 9, 2))
        prev = scene(rng, ox, oy)
        cur = scene(rng, min(max(ox + dx, 0), 130), min(max(oy + dy, 0), 80))
        rect = [ox - 2, oy - 2, 34, 44]
        got = ncc_track(prev, rect, cur)
        assert got == jncc_track(prev, rect, cur)
        n += got != rect
    assert n > 20                     # the tracker moved the box


def _sequence(tmp_path, rng, n=6, missing=False):
    """A manifest's samples over PNG frames of a moving object (and a path
    that does not exist)."""
    paths = []
    for i in range(n):
        p = str(tmp_path / f"f{i}.png")
        cv.imwrite(p, scene(rng, 40 + 4 * i, 30 + 2 * i))
        paths.append(p)
    if missing:
        paths.insert(2, str(tmp_path / "missing.png"))
    rects = [[38, 28, 34, 44]] * len(paths)
    rects[-1] = [150, 100, 40, 40]             # runs out of the frame
    return paths, rects


def test_refine_manifest_matches_tpufcn(tmp_path, extractors):
    jext, ext = extractors
    paths, rects = _sequence(tmp_path, np.random.default_rng(5),
                             missing=True)
    jsamples = [JDetectionSample(p, np.array([r]), np.array([2]))
                for p, r in zip(paths, rects)]
    samples = [DetectionSample(p, np.array([r]), np.array([2]))
               for p, r in zip(paths, rects)]
    want, got = str(tmp_path / "want.txt"), str(tmp_path / "got.txt")
    assert JBoundaryRefiner(extractor=jext).refine_manifest(jsamples, want) \
        == BoundaryRefiner(extractor=ext).refine_manifest(samples, got) == 7
    lines = open(got).read().splitlines()
    assert lines == open(want).read().splitlines()
    # the tracker's boxes were taken where the codes stayed close
    assert sum(l.split()[1:5] != ["38", "28", "34", "44"]
               for l in lines[:-1]) >= 3


def test_refine_live_matches_tpufcn():
    rng = np.random.default_rng(6)
    jref, ref = JBoundaryRefiner(), BoundaryRefiner()
    got, want = [], []
    for i in range(8):
        img = scene(rng, 40 + 5 * i, 30 + 3 * i, hw=(160, 240))
        rect = [38 + 4 * i, 28 + 2 * i, 34, 44]
        got.append(ref.refine_live(img, rect))
        want.append(jref.refine_live(img, rect))
    assert got == want and got[0] is None and all(got[1:])
    # the live path never builds the extractor
    assert ref._extractor is None


def _same_results(clf, jclf, imgs, rects):
    n = 0
    for img in imgs:
        got, want = clf(img, rects), jclf(img, rects)
        assert [(r, l) for r, l, _ in got] == [(r, l) for r, l, _ in want]
        np.testing.assert_allclose([p for *_, p in got],
                                   [p for *_, p in want], rtol=1e-5)
        n += len(got)
    return got, n


def test_roi_classifier_matches_tpufcn(extractors):
    jext, ext = extractors
    rng = np.random.default_rng(7)
    imgs = [scene(rng, 40, 30) for _ in range(4)]
    crops = [i[30:70, 40:70] for i in imgs] + [i[0:30, 0:30] for i in imgs]
    labels = np.array([1] * 4 + [0] * 4)
    # in the frame, clamped, and too thin (dropped)
    rects = [[40, 30, 30, 40], [0, 0, 30, 30], [-5, 100, 40, 40],
             [150, 0, 30, 30], [10, 10, 1, 20]]
    # the random heads are the same draws; a threshold of 0 keeps each rect
    clf = ROIClassifier(3, extractor=ext, prob_thresh=0.0, seed=3)
    jclf = JROIClassifier(3, extractor=jext, prob_thresh=0.0, seed=3)
    codes = np.random.default_rng(8).normal(size=(5, 512))
    assert np.array_equal(clf.head(codes), jclf.head(codes))
    assert _same_results(clf, jclf, imgs[:2], rects)[1] == 8
    # the fitted heads, on the same codes
    clf, jclf = ROIClassifier(2, extractor=ext), JROIClassifier(
        2, extractor=jext)
    clf.fit_head(ext(crops), labels, 2)
    jclf.fit_head(ext(crops), labels, 2)
    got, _ = _same_results(clf, jclf, imgs, rects)
    assert got[0][:2] == ([40, 30, 30, 40], 1)


def test_roi_classifier_node_matches_tpufcn(extractors):
    jext, ext = extractors
    out = {}
    for tag, bus, node_cls, clf in (
            ("port", TopicBus(), ROIClassifierNode,
             ROIClassifier(2, extractor=ext, prob_thresh=0.0)),
            ("jax", JTopicBus(), JROIClassifierNode,
             JROIClassifier(2, extractor=jext, prob_thresh=0.0))):
        node_cls(bus, clf)
        got = []
        bus.subscribe("/rcnn_detector/rects", got.append)
        rng = np.random.default_rng(10)
        for t in range(2):
            bus.publish("image", scene(rng, 40 + 6 * t, 30), stamp=float(t))
            bus.publish("/fcn_object_detector/rects",
                        RectsMsg([(40, 30), (70, 70), (0, 0), (25, 25)],
                                 [0, 0], [0.9, 0.8]), stamp=float(t))
            bus.spin_once()
        bus.spin_once()
        out[tag] = [(m.stamp, m.data.points, m.data.labels,
                     m.data.confidences) for m in got]
    assert len(out["port"]) == len(out["jax"]) == 2
    for g, w in zip(out["port"], out["jax"]):
        assert g[:3] == w[:3] and len(g[1]) == 4
        np.testing.assert_allclose(g[3], w[3], rtol=1e-5)


def test_capture_matches_tpufcn(tmp_path):
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
              for _ in range(3)]
    rects = [[-5, 10, 200, 30], [10, 5, 20, 20], [90, 0, 10, 10]]
    dirs = {}
    for tag, bus, writer in (("port", TopicBus(), ImageRectWriter),
                             ("jax", JTopicBus(), JImageRectWriter)):
        d = str(tmp_path / tag)
        w = writer(bus, d, label=2)
        for t, (f, r) in enumerate(zip(frames, rects)):
            bus.publish("/camera/rgb/image_rect_color", f, stamp=float(t))
            bus.publish("/object_rect", r, stamp=float(t))
            bus.spin_once()
        assert w.counter == w.processed == 2     # the last rect is outside
        dirs[tag] = d
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"])) == [
        "00000000.jpg", "00000001.jpg", "train.txt"]
    for n in names[:2]:
        assert open(os.path.join(dirs["port"], n), "rb").read() == \
            open(os.path.join(dirs["jax"], n), "rb").read()
    got = open(os.path.join(dirs["port"], "train.txt")).read()
    assert got == open(os.path.join(dirs["jax"], "train.txt")).read() \
        .replace(dirs["jax"], dirs["port"])
    assert got.splitlines()[0].split()[1:] == ["0", "10", "80", "30", "2"]


def test_capture_resumes_numbering(tmp_path):
    d = str(tmp_path / "cap")
    os.makedirs(d)
    for name in ("00000004.jpg", "00000011.jpg", "notes.jpg", "1.jpg"):
        open(os.path.join(d, name), "wb").close()
    bus = TopicBus()
    w = ImageRectWriter(bus, d)
    jw = JImageRectWriter(JTopicBus(), d)
    assert w.counter == jw.counter == 12 and w.processed == 0
    bus.publish("/camera/rgb/image_rect_color",
                np.zeros((20, 20, 3), np.uint8), stamp=0.0)
    bus.publish("/object_rect", [0, 0, 5, 5], stamp=0.0)
    bus.spin_once()
    assert os.path.isfile(os.path.join(d, "00000012.jpg"))
    assert (w.counter, w.processed) == (13, 1)
    assert ImageRectWriter(TopicBus(), d).counter == 13


IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|tpufcn|cv2|sklearn)\b",
                    re.M)


def test_port_imports_no_jax_cv2_or_sklearn():
    files = glob.glob(os.path.join(ROOT, "torchfcn", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 60
    found = {os.path.relpath(f, ROOT): IMPORT.findall(open(f).read())
             for f in files}
    assert {f: m for f, m in found.items() if m} == {}
