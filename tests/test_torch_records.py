"""The port's record shards (``torchfcn/data/records.py``) against tpufcn's
(``tpufcn/data/records.py``) and the blur and flip of its offline
augmentation (``torchfcn/data/raster.py``) against cv2:

* ``create_detection_records`` writes shards (``.rec``, ``.idx``) and label
  maps byte-equal to tpufcn's from the same manifest and seed, plain and
  with ``augment``, ``relabel_contiguous`` and ``add_background``, on a
  tiny manifest of fixture JPEGs, a PNG and a missing file;
* each package reads the other's shards: the same records;
* ``_pack`` byte-equal to tpufcn's, ``_unpack`` its inverse; the shard
  glob takes only the writer's names; a reader pickles without handles;
* ``gaussian_blur_u8`` bit-equal to ``cv.GaussianBlur(img, (kx, ky), 0)``
  for every (kx, ky) in {3, 5, 7}^2, ``flip_image_with_rects`` equal to
  tpufcn's for every flip code.
"""

import os
import pickle

import cv2 as cv
import numpy as np
import pytest

from tpufcn.data import compositor as jcomp
from tpufcn.data import records as jrec
from torchfcn.data import records as prec
from torchfcn.data.imageio import imwrite
from torchfcn.data.manifest import DetectionSample, read_voc_manifest
from torchfcn.data.raster import flip_image_with_rects, gaussian_blur_u8
from torchfcn.data.voc import PascalVOC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "voc_mini")


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Five fixture train images with their boxes under labels 3 / 7 / 9,
    a PNG with two boxes and a missing file."""
    d = tmp_path_factory.mktemp("manifest")
    PascalVOC(FIXTURE, classes=("ball", "crate", "cone")).create(str(d))
    out = [DetectionSample(s.image_path, s.rects,
                           np.asarray([(3, 7, 9)[l] for l in s.labels],
                                      np.int32))
           for s in read_voc_manifest(str(d / "train.txt"))[:5]]
    png = str(d / "synthetic.png")
    imwrite(png, np.random.default_rng(1).integers(0, 256, (61, 90, 3),
                                                   dtype=np.uint8))
    out.append(DetectionSample(png, np.asarray([[5, 7, 20, 30],
                                                [40, 10, 12, 12]], np.int32),
                               np.asarray([7, 11], np.int32)))
    out.append(DetectionSample(str(d / "missing.jpg"),
                               np.asarray([[0, 0, 4, 4]], np.int32),
                               np.asarray([3], np.int32)))
    return out


def _files(prefix):
    d = os.path.dirname(prefix)
    base = os.path.basename(prefix)
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.startswith(base)}


OPTIONS = [dict(), dict(augment=True), dict(relabel_contiguous=True),
           dict(add_background=True),
           dict(augment=True, relabel_contiguous=True, add_background=True),
           dict(shuffle_seed=None), dict(shuffle_seed=5, augment=True)]


@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: "-".join(
    f"{k}={v}" for k, v in o.items()) or "plain")
def test_shards_byte_equal_to_tpufcn(samples, tmp_path, options):
    want_n = jrec.create_detection_records(
        samples, str(tmp_path / "jax" / "ds"), **options)
    got_n = prec.create_detection_records(
        samples, str(tmp_path / "port" / "ds"), **options)
    assert got_n == want_n == (24 if options.get("augment") else 6)
    want = _files(str(tmp_path / "jax" / "ds"))
    got = _files(str(tmp_path / "port" / "ds"))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def _same_records(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        ra, rb = a.read(i), b.read(i)
        assert sorted(ra) == sorted(rb)
        for k in ra:
            assert ra[k].dtype == rb[k].dtype
            np.testing.assert_array_equal(ra[k], rb[k])


def test_each_package_reads_the_others_shards(samples, tmp_path):
    jp, pp = str(tmp_path / "jax" / "ds"), str(tmp_path / "port" / "ds")
    jrec.create_detection_records(samples, jp, augment=True)
    prec.create_detection_records(samples, pp, augment=True)
    _same_records(prec.RecordReader(jp), jrec.RecordReader(jp))
    _same_records(jrec.RecordReader(pp), prec.RecordReader(pp))
    got = prec.read_records(jp, limit=3)
    want = jrec.read_records(pp, limit=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["image"].shape[2] == 3


def test_pack_unpack_and_shard_names(tmp_path):
    rec = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
           "b": np.float32(2.5), "c": np.zeros((0, 4), np.int64),
           "ü/key": np.array([True, False])}
    buf = prec._pack(rec)
    assert buf == jrec._pack(rec)
    back = prec._unpack(buf)
    assert back.keys() == jrec._unpack(buf).keys() == rec.keys()
    for k, v in rec.items():
        # a 0-d value is stored with shape (1,) (np.ascontiguousarray), as
        # tpufcn stores it
        v = np.atleast_1d(v)
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
    with prec.RecordWriter(str(tmp_path / "ds"), records_per_shard=2) as w:
        for i in range(5):
            w.write({"i": np.int64(i)})
    with prec.RecordWriter(str(tmp_path / "ds-aug")) as w:
        w.write({"i": np.int64(99)})
    names = [os.path.basename(f) for f in
             prec._glob_prefix(str(tmp_path / "ds"))]
    assert names == [os.path.basename(f) for f in
                     jrec._glob_prefix(str(tmp_path / "ds"))]
    assert names == [f"ds-0000{i}.{e}" for i in range(3)
                     for e in ("idx", "rec")]
    r = prec.RecordReader(str(tmp_path / "ds"))
    assert [int(x["i"][0]) for x in r] == list(range(5))
    clone = pickle.loads(pickle.dumps(r))
    assert clone._handles == [None] * 3 and int(clone.read(4)["i"][0]) == 4
    with pytest.raises(FileNotFoundError):
        prec.RecordReader(str(tmp_path / "none"))


BLUR_SHAPES = [(37, 53, 3), (5, 4, 3), (1, 7, 3), (2, 2, 3), (40, 30)]


@pytest.mark.parametrize("ky", [3, 5, 7])
@pytest.mark.parametrize("kx", [3, 5, 7])
def test_gaussian_blur_bit_equal_to_cv2(kx, ky):
    rng = np.random.default_rng(kx * 10 + ky)
    for shape in BLUR_SHAPES:
        img = rng.integers(0, 256, shape, np.uint8)
        np.testing.assert_array_equal(
            gaussian_blur_u8(img, (kx, ky)), cv.GaussianBlur(img, (kx, ky), 0),
            err_msg=str(shape))


@pytest.mark.parametrize("code", [-1, 0, 1])
def test_flip_equal_to_tpufcn(code):
    img = np.random.default_rng(code + 2).integers(0, 256, (13, 21, 3),
                                                   np.uint8)
    rects = [[2, 3, 5, 4], [0, 0, 21, 13], [19, 11, 1, 1]]
    got, got_r = flip_image_with_rects(img, rects, code)
    want, want_r = jcomp.flip_image_with_rects(img, rects, code)
    np.testing.assert_array_equal(got, want)
    assert got_r == want_r
