"""Clustering of CNN codes on the host, without scikit-learn: what the
ranking tool asks of scikit-learn's ``DBSCAN``, ``KMeans`` and
``NearestNeighbors`` (``tpufcn/tools/rank_proposals.py:68-82``).

``dbscan`` gives ``DBSCAN(eps, min_samples).fit_predict`` labels;
``kmeans`` follows ``KMeans(k, n_init, random_state=seed)``: greedy
k-means++ seeding drawn from one ``np.random.RandomState`` in
scikit-learn's order, then Lloyd's iterations on the centred data, in
float64 (scikit-learn computes float32 codes in float32, so its centroids
agree to float32 rounding where both assign every point alike);
``nearest_distances`` is a brute-force ``kneighbors``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _sq_distances(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(len(x), len(y)) squared Euclidean distances, float64, from the
    norms and the products (scikit-learn's form), at least 0."""
    d = -2.0 * (x @ y.T)
    d += (x * x).sum(1)[:, None]
    d += (y * y).sum(1)[None, :]
    return np.maximum(d, 0.0)


def dbscan(x: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN labels of the rows of ``x``: -1 for noise, clusters numbered
    0, 1, ... in the order in which their first core point appears.  A
    point's neighbourhood is every row within Euclidean distance ``eps``
    (itself included); a core point has at least ``min_samples``
    neighbours.  A border point reachable from two clusters joins the one
    numbered first."""
    x = np.asarray(x, np.float64)
    near = np.sqrt(_sq_distances(x, x)) <= eps
    np.fill_diagonal(near, True)
    core = near.sum(1) >= min_samples
    labels = np.full(len(x), -1, np.intp)
    label = 0
    for i in np.flatnonzero(core):
        if labels[i] != -1:
            continue
        labels[i] = label
        stack = [i]
        while stack:
            j = stack.pop()
            if not core[j]:
                continue
            fresh = np.flatnonzero(near[j] & (labels == -1))
            labels[fresh] = label
            stack.extend(fresh.tolist())
        label += 1
    return labels


def _kmeans_plusplus(x: np.ndarray, k: int,
                     rs: np.random.RandomState) -> np.ndarray:
    """k-means++ seeds: the first a uniform draw, each next the best of
    2 + int(log k) candidates drawn in proportion to the squared distance
    to the nearest seed (scikit-learn's ``_kmeans_plusplus``)."""
    n = len(x)
    trials = 2 + int(np.log(k))
    weights = np.ones(n)
    centers = np.empty((k, x.shape[1]))
    first = rs.choice(n, p=weights / weights.sum())
    centers[0] = x[first]
    closest = _sq_distances(x[first][None], x)[0]
    pot = closest @ weights
    for c in range(1, k):
        draws = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(weights * closest), draws)
        np.clip(ids, None, n - 1, out=ids)
        cand = np.minimum(closest, _sq_distances(x[ids], x))
        pots = cand @ weights
        best = int(np.argmin(pots))
        pot, closest = pots[best], cand[best]
        centers[c] = x[ids[best]]
    return centers


def _lloyd_step(x: np.ndarray, centers: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """One Lloyd iteration: (labels from ``centers``, the new centers).  An
    empty cluster takes the point farthest from its center, as
    scikit-learn relocates it; a cluster left without weight moves to the
    heaviest cluster's center."""
    k = len(centers)
    labels = _assign(x, centers)
    sums = np.zeros_like(centers)
    np.add.at(sums, labels, x)
    weight = np.bincount(labels, minlength=k).astype(np.float64)
    empty = np.flatnonzero(weight == 0)
    if len(empty):
        dist = ((x - centers[labels]) ** 2).sum(1)
        if dist.max() > 0:
            far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
            for new, idx in zip(empty, far):
                old = labels[idx]
                sums[old] -= x[idx]
                sums[new] = x[idx]
                weight[new] = 1.0
                weight[old] -= 1.0
    heaviest = int(np.argmax(weight))
    new_centers = np.empty_like(centers)
    for j in range(k):
        new_centers[j] = (sums[j] * (1.0 / weight[j]) if weight[j] > 0
                          else sums[heaviest] * (1.0 / weight[heaviest]))
    return labels, new_centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """The nearest center of each row (the first of equals)."""
    d = (centers * centers).sum(1)[None, :] - 2.0 * (x @ centers.T)
    return np.argmin(d, axis=1)


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """Whether two labelings are equal up to a renaming of the labels."""
    mapping = np.full(k, -1)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans(x: np.ndarray, k: int, n_init: int = 4, seed: int = 0,
           max_iter: int = 300, tol: float = 1e-4) -> np.ndarray:
    """(k, D) float64 centroids of the rows of ``x``: the lowest-inertia of
    ``n_init`` runs of k-means++ seeding and Lloyd's iterations, as
    ``KMeans(k, n_init=n_init, random_state=seed).fit(x).cluster_centers_``.
    A run stops when the labels repeat, or when the centers' squared shift
    is at most ``tol`` times the mean of the columns' variances (then the
    labels are taken once more from the last centers)."""
    x = np.asarray(x, np.float64)
    if not 1 <= k <= len(x):
        raise ValueError(f"k = {k} clusters of {len(x)} points")
    tol = float(np.mean(np.var(x, axis=0))) * tol
    mean = x.mean(axis=0)
    x = x - mean
    rs = np.random.RandomState(seed)
    best = None
    for _ in range(n_init):
        centers = _kmeans_plusplus(x, k, rs)
        labels_old = np.full(len(x), -1)
        converged = False
        for _ in range(max_iter):
            labels, new = _lloyd_step(x, centers)
            shift = ((new - centers) ** 2).sum()
            centers = new
            if np.array_equal(labels, labels_old):
                converged = True
                break
            if shift <= tol:
                break
            labels_old = labels
        if not converged:
            labels = _assign(x, centers)
        inertia = float(((x - centers[labels]) ** 2).sum())
        if best is None or (inertia < best[0] and not _same_clustering(
                labels, best[1], k)):
            best = (inertia, labels, centers)
    return best[2] + mean


def nearest_distances(x: np.ndarray, centroids: np.ndarray,
                      n: int) -> np.ndarray:
    """(len(x), n) Euclidean distances of each row of ``x`` to its ``n``
    nearest centroids, ascending, float64 by brute force
    (``NearestNeighbors(n_neighbors=n).fit(centroids).kneighbors(x)[0]``)."""
    x = np.asarray(x, np.float64)
    c = np.asarray(centroids, np.float64)
    d = np.sqrt(((x[:, None, :] - c[None, :, :]) ** 2).sum(-1))
    return np.sort(d, axis=1)[:, :n]
