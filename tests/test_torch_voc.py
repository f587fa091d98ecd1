"""The port's VOC converter and manifests (``torchfcn/data/voc.py``,
``torchfcn/data/manifest.py``), its record batches
(``torchfcn/data/pipeline.py::RecordTrainPipeline``) and held-out sets
(``torchfcn/train/validate.py``) against tpufcn's on the committed fixture
``tests/fixtures/voc_mini``:

* ``PascalVOC.create`` writes train / val / class-name manifests
  byte-equal to tpufcn's (48 / 96 samples); every annotation parses the
  same; the manifest readers and ``detection_line`` agree;
* ``RecordTrainPipeline`` yields tpufcn's batches for the same seed
  (images, rects, labels, valid), across a reshuffle, from shards written
  with and without a background shift;
* ``val_set_from_voc`` and ``val_set_from_records`` return tpufcn's images
  and corner boxes.
"""

import glob
import itertools
import os

import numpy as np
import pytest

from tpufcn.core.config import GridConfig as JGrid
from tpufcn.data import manifest as jman
from tpufcn.data import pipeline as jpipe
from tpufcn.data import voc as jvoc
from tpufcn.train import validate as jval
from torchfcn.core.config import GridConfig
from torchfcn.data import manifest as pman
from torchfcn.data import voc as pvoc
from torchfcn.data.pipeline import RecordTrainPipeline
from torchfcn.data.records import create_detection_records
from torchfcn.train import validate as pval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "voc_mini")
CLASSES = ("ball", "crate", "cone")


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """tpufcn's and the port's converter outputs on the fixture."""
    root = tmp_path_factory.mktemp("voc")
    jvoc.PascalVOC(FIXTURE, classes=CLASSES).create(str(root / "jax"))
    pvoc.PascalVOC(FIXTURE, classes=CLASSES).create(str(root / "port"))
    return root


def test_create_writes_tpufcn_manifests(manifests):
    for name, lines in (("train.txt", 48), ("val.txt", 96),
                        ("class_label_names.txt", 3)):
        got = (manifests / "port" / name).read_bytes()
        assert got == (manifests / "jax" / name).read_bytes(), name
        assert len(got.decode().splitlines()) == lines
    assert pvoc.VOC_CLASSES == jvoc.VOC_CLASSES


def test_annotations_parse_as_tpufcn():
    files = sorted(glob.glob(os.path.join(FIXTURE, "Annotations", "*.xml")))
    assert len(files) == 144
    for f in files:
        assert pvoc.parse_annotation(f) == jvoc.parse_annotation(f)


def test_manifest_readers_agree(manifests, tmp_path):
    for split in ("train", "val"):
        path = str(manifests / "port" / f"{split}.txt")
        got, want = pman.read_voc_manifest(path), \
            jman.read_voc_manifest(path)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.image_path == b.image_path
            np.testing.assert_array_equal(a.rects, b.rects)
            np.testing.assert_array_equal(a.labels, b.labels)
    odd = tmp_path / "odd.txt"
    odd.write_text("a.jpg,1 2 3 4 0,bad group,5 6 7 8 2\nb.jpg\n"
                   "c.jpg,1.7 2 3 4 1\n")
    got, want = pman.read_voc_manifest(str(odd)), \
        jman.read_voc_manifest(str(odd))
    assert [(s.image_path, s.rects.tolist(), s.labels.tolist())
            for s in got] == [(s.image_path, s.rects.tolist(),
                               s.labels.tolist()) for s in want]
    pman.write_voc_manifest(str(tmp_path / "p.txt"), got)
    jman.write_voc_manifest(str(tmp_path / "j.txt"), want)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt") \
        .read_bytes()
    for rect, label, one in itertools.product(([1, 2, 3, 4], [0.0, 5, 7, 9]),
                                              (0, 4), (True, False)):
        assert pman.detection_line("x.png", rect, label, one) == \
            jman.detection_line("x.png", rect, label, one)


@pytest.fixture(scope="module")
def shards(manifests):
    """Record shards of the train split, plain and with a background
    shift, written by the port (byte-equal to tpufcn's:
    tests/test_torch_records.py)."""
    samples = pman.read_voc_manifest(str(manifests / "port" / "train.txt"))
    out = {}
    for tag, kw in (("plain", {}), ("background", dict(add_background=True))):
        prefix = str(manifests / "rec" / tag / "ds")
        assert create_detection_records(samples, prefix, **kw) == 48
        out[tag] = prefix
    return out


@pytest.mark.parametrize("tag", ["plain", "background"])
def test_record_batches_equal_tpufcn(shards, tag):
    """Batches of 20 from 48 records: the third reshuffles mid-batch."""
    grid, jgrid = (cls(96, 128, stride=8, num_classes=4)
                   for cls in (GridConfig, JGrid))
    got = iter(RecordTrainPipeline(shards[tag], grid, batch_size=20,
                                   box_capacity=4, seed=1000))
    want = iter(jpipe.RecordTrainPipeline(shards[tag], jgrid, batch_size=20,
                                          box_capacity=4, seed=1000))
    for _ in range(4):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b) == ["image", "labels", "rects", "valid"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["labels"][a["valid"]].min() == 0


def _same_val_sets(got, want):
    (gi, gg), (wi, wg) = got, want
    np.testing.assert_array_equal(gi, wi)
    assert len(gg) == len(wg)
    for (gc, gl), (wc, wl) in zip(gg, wg):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("hw", [(448, 448), (224, 224), (120, 160)])
def test_val_set_from_voc_equals_tpufcn(manifests, hw):
    path = str(manifests / "port" / "val.txt")
    got = pval.val_set_from_voc(path, hw, limit=12)
    _same_val_sets(got, jval.val_set_from_voc(path, hw, limit=12))
    assert got[0].shape == (12,) + hw + (3,)


def test_val_set_from_voc_whole_split(manifests):
    path = str(manifests / "port" / "val.txt")
    images, gts = pval.val_set_from_voc(path, (448, 448))
    assert images.shape == (96, 448, 448, 3)
    assert sum(len(g[1]) for g in gts) == 168


@pytest.mark.parametrize("limit", [None, 7])
def test_val_set_from_records_equals_tpufcn(shards, limit):
    got = pval.val_set_from_records(shards["plain"], (224, 224), limit=limit)
    _same_val_sets(got, jval.val_set_from_records(shards["plain"],
                                                  (224, 224), limit=limit))
    assert got[0].shape[0] == (limit or 48)

