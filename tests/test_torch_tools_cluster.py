"""The port's clustering (``torchfcn/tools/cluster.py``) against
scikit-learn, and its proposal ranking against tpufcn's, on the CPU.

The codes are seeded stand-ins for CNN codes (non-negative, unit norm,
float32, 512 values) drawn around a few centres, with clusters that are
separated and clusters that overlap.  ``dbscan`` must give
``DBSCAN(eps, min_samples).fit_predict``'s labels exactly, ``kmeans``
centroids within 1e-5 of ``KMeans(k, n_init=4, random_state=0)``'s, and
``nearest_distances`` ``NearestNeighbors.kneighbors``'s distances.  The
ranking walk over a manifest of crops (``RankObjectProposals``, both
metrics) must keep the same lines as tpufcn's with the same extractor
weights (tpufcn's, carried across by ``from_jax``).
"""

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN, KMeans
from sklearn.neighbors import NearestNeighbors

from tpufcn.data.manifest import read_detection_manifest as jread_manifest
from tpufcn.tools import (
    CnnCodeExtractor as JCnnCodeExtractor,
    RankObjectProposals as JRankObjectProposals)
from torchfcn.data.manifest import read_detection_manifest
from torchfcn.tools import CnnCodeExtractor, RankObjectProposals
from torchfcn.tools.cluster import dbscan, kmeans, nearest_distances

torch.set_num_threads(2)

CENTROID_ATOL = 1e-5


def codes(rng, n, centres, spread):
    """(n, 512) float32 unit-norm non-negative codes around ``centres``
    random centres, each value perturbed by N(0, spread)."""
    c = np.abs(rng.normal(size=(centres, 512)))
    x = np.abs(c[rng.integers(0, centres, n)]
               + rng.normal(0, spread, (n, 512)))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


# (centres, spread): separated clusters, overlapping ones, one cloud
CASES = [(3, 0.02), (3, 0.08), (4, 0.12), (1, 0.05)]


@pytest.mark.parametrize("centres,spread", CASES)
def test_dbscan_matches_sklearn(centres, spread):
    rng = np.random.default_rng(centres * 100 + int(spread * 100))
    for n in (12, 60, 150):
        x = codes(rng, n, centres, spread)
        for eps in (0.15, 0.25, 0.4):
            for min_samples in (3, 10):
                want = DBSCAN(eps=eps, min_samples=min_samples).fit_predict(x)
                got = dbscan(x, eps, min_samples)
                assert np.array_equal(got, want), (n, eps, min_samples)


def test_dbscan_border_point_joins_first_cluster():
    # 1.15 is within eps of a core of each cluster and no core itself
    a, b = [-0.6, -0.3, 0.0, 0.3], [2.0, 2.3, 2.6, 2.9]
    for first, second in ((a, b), (b, a)):
        x = np.array(first + [1.15] + second)[:, None]
        got = dbscan(x, 1.0, 4)
        assert np.array_equal(got, DBSCAN(eps=1.0, min_samples=4)
                              .fit_predict(x))
        assert got.tolist() == [0] * 5 + [1] * 4


@pytest.mark.parametrize("centres,spread", CASES)
def test_kmeans_matches_sklearn(centres, spread):
    rng = np.random.default_rng(centres * 10 + int(spread * 1000))
    for n in (5, 40, 120):
        x = codes(rng, n, centres, spread)
        for k in (1, 2, 3):
            want = KMeans(n_clusters=k, n_init=4, random_state=0) \
                .fit(x).cluster_centers_
            got = kmeans(x, k, n_init=4, seed=0)
            assert got.shape == (k, 512)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=CENTROID_ATOL)


def test_kmeans_rejects_more_clusters_than_points():
    with pytest.raises(ValueError):
        kmeans(np.zeros((2, 4)), 3)


def test_nearest_distances_match_sklearn():
    rng = np.random.default_rng(7)
    x, c = codes(rng, 9, 2, 0.1), codes(rng, 5, 2, 0.1)
    for n in (1, 2):
        want, _ = NearestNeighbors(n_neighbors=n).fit(c).kneighbors(x)
        np.testing.assert_allclose(nearest_distances(x, c, n), want,
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def extractors():
    jext = JCnnCodeExtractor(input_size=64, dtype=jnp.float32)
    return jext, CnnCodeExtractor.from_jax(
        jax.tree.map(np.asarray, jext.params), input_size=64,
        dtype=torch.float32, device="cpu")


def crop_manifest(tmp_path, rng):
    """A manifest of 16 frames: a textured object moving across noise,
    with two frames whose box holds only noise and one whose box runs
    out of the frame."""
    gy, gx = np.mgrid[0:40, 0:30]
    patch = np.stack([30 + gx * 4, 200 - gy * 3,
                      120 + ((gx + gy) % 7) * 10],
                     axis=-1).clip(0, 255).astype(np.uint8)
    lines = []
    for i in range(16):
        img = rng.integers(0, 60, (120, 160, 3)).astype(np.uint8)
        ox, oy = 20 + 5 * i, 30 + (i % 4)
        if i in (6, 11):
            img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
        else:
            img[oy:oy + 40, ox:ox + 30] = patch
        p = str(tmp_path / f"f{i:02d}.png")
        cv.imwrite(p, img)
        rect = (ox - 2, oy - 2, 34, 44) if i != 15 else (150, 100, 40, 40)
        lines.append(f"{p} {' '.join(map(str, rect))} 1")
    man = str(tmp_path / "train.txt")
    with open(man, "w") as f:
        f.write("\n".join(lines) + "\n")
    return man


@pytest.mark.parametrize("metric", ["bhattacharyya", "chi_square"])
def test_write_filtered_matches_tpufcn(tmp_path, extractors, metric):
    jext, ext = extractors
    man = crop_manifest(tmp_path, np.random.default_rng(1))
    # the seeded backbone's codes of all these crops lie within 0.11 of
    # each other, the object's within 0.01, at distances of 0.005
    # (Bhattacharyya) and 0.002 (chi^2) from frame to frame and ten to a
    # hundred times that to the noise: the thresholds and eps sit between
    thresh = 0.03 if metric == "bhattacharyya" else 0.05
    kw = dict(metric=metric, distance_thresh=thresh, dbscan_eps=0.03,
              dbscan_min_samples=4)
    ranker = RankObjectProposals(extractor=ext, **kw)
    jranker = JRankObjectProposals(extractor=jext, **kw)
    samples = read_detection_manifest(man)
    codes_ = ranker.codes_for(samples)
    want_codes = jranker.codes_for(jread_manifest(man))
    np.testing.assert_allclose(codes_, want_codes, rtol=0, atol=1e-5)
    labels, centroids = ranker.cluster_data(codes_)
    want_labels, want_centroids, _ = jranker.cluster_data(codes_)
    assert np.array_equal(labels, want_labels)
    assert set(labels.tolist()) == {-1, 0}
    np.testing.assert_allclose(centroids, want_centroids, rtol=0,
                               atol=CENTROID_ATOL)
    got, want = str(tmp_path / "got.txt"), str(tmp_path / "want.txt")
    n = ranker.write_filtered(samples, got)
    assert n == jranker.write_filtered(jread_manifest(man), want)
    assert open(got).read() == open(want).read()
    # the noise frames and the box out of the frame are dropped
    assert [l.split()[0][-7:-4] for l in open(got)] == [
        f"f{i:02d}" for i in range(16) if i not in (6, 11, 15)]
