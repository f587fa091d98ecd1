"""Training-data ranking / outlier rejection
(``tpufcn/tools/rank_proposals.py``).

Mirrors reference scripts/boundary_adjustment/rank_object_models.py:
extract CNN codes per GT crop, DBSCAN-cluster them (eps 0.25, min 10 —
reference :186-206), build per-cluster KMeans(2) centroids feeding a
nearest-centroid test (:203-267), then walk the sequence comparing
template / previous / current codes with chi^2 and Bhattacharyya
distances, EMA-updating the template (rate 0.1, reference :117-179), and
write the filtered manifest (``train2.txt``).  The codes come from the
card (``CnnCodeExtractor``); the clustering runs on the host in numpy
(``tools/cluster.py``), where the JAX package calls scikit-learn.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from torchfcn.data.imageio import imread
from torchfcn.data.manifest import DetectionSample, detection_line
from torchfcn.tools.cluster import dbscan, kmeans, nearest_distances
from torchfcn.tools.features import CnnCodeExtractor, bhattacharyya, chi_square


class RankObjectProposals:
    def __init__(self,
                 extractor: Optional[CnnCodeExtractor] = None,
                 dbscan_eps: float = 0.25,
                 dbscan_min_samples: int = 10,
                 kmeans_k: int = 2,
                 ema_rate: float = 0.1,
                 distance_thresh: float = 0.5,
                 metric: str = "bhattacharyya",
                 imread=imread):
        # metric: "bhattacharyya" or "chi_square".  The reference walk
        # uses cv.compareHist with CV_COMP_BHATTACHARYYA on its OpenCV-2
        # path and HISTCMP_CHISQR on OpenCV-3+ (rank_object_models.py:
        # 46-52); both are exposed, Bhattacharyya (bounded [0, 1], so
        # the 0.5 default threshold is meaningful) is the default.
        self.extractor = extractor or CnnCodeExtractor()
        self.dbscan_eps = dbscan_eps
        self.dbscan_min_samples = dbscan_min_samples
        self.kmeans_k = kmeans_k
        self.ema_rate = ema_rate
        self.distance_thresh = distance_thresh
        self.metric = {"bhattacharyya": bhattacharyya,
                       "chi_square": chi_square}[metric]
        self.imread = imread

    def codes_for(self, samples: Sequence[DetectionSample]) -> np.ndarray:
        crops = []
        for s in samples:
            img = self.imread(s.image_path)
            x, y, w, h = [int(v) for v in s.rects[0]]
            # clamp the origin INSIDE the frame (an out-of-frame rect
            # otherwise yields an empty crop, which the resize cannot take)
            x = min(max(x, 0), img.shape[1] - 1)
            y = min(max(y, 0), img.shape[0] - 1)
            w = max(min(w, img.shape[1] - x), 1)
            h = max(min(h, img.shape[0] - y), 1)
            crops.append(img[y:y + h, x:x + w])
        return self.extractor(crops)

    def cluster_data(self, codes: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """DBSCAN -> per-cluster k-means centroids.

        Returns (cluster_labels, centroids)."""
        labels = dbscan(codes, self.dbscan_eps,
                        min(self.dbscan_min_samples, max(len(codes) - 1, 1)))
        centroids = []
        for c in sorted(set(labels.tolist()) - {-1}):
            members = codes[labels == c]
            centroids.extend(kmeans(members, min(self.kmeans_k,
                                                 len(members)),
                                    n_init=4, seed=0))
        return labels, np.asarray(centroids)

    def rank(self, samples: Sequence[DetectionSample]) -> np.ndarray:
        """Boolean keep-mask over the sequence."""
        codes = self.codes_for(samples)
        _, centroids = self.cluster_data(codes)

        keep = np.zeros(len(samples), bool)
        template = None
        prev = None
        for i, code in enumerate(codes):
            if template is None:
                template = code.copy()
                prev = code
                keep[i] = True
                continue
            d_t = self.metric(code, template)
            d_p = self.metric(code, prev)
            inlier = True
            if len(centroids):
                dist = nearest_distances(code[None], centroids,
                                         min(2, len(centroids)))
                inlier = bool(dist.min() < self.dbscan_eps * 2)
            ok = (min(d_t, d_p) < self.distance_thresh) and inlier
            keep[i] = ok
            if ok:
                # EMA template update (reference rate 0.1)
                template = ((1 - self.ema_rate) * template
                            + self.ema_rate * code)
                prev = code
        return keep

    def write_filtered(self, samples: Sequence[DetectionSample],
                       out_path: str,
                       one_based_labels: bool = True) -> int:
        keep = self.rank(samples)
        n = 0
        with open(out_path, "w") as f:
            for s, ok in zip(samples, keep):
                if not ok:
                    continue
                f.write(detection_line(s.image_path, s.rects[0],
                                       s.labels[0], one_based_labels)
                        + "\n")
                n += 1
        return n
