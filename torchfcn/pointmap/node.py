"""Python binding and stream node of the C++ point-map fusion library
(``tpufcn/pointmap/node.py``, ported).

The heavy lifting (Otsu, connected regions, IoU gating, mask XOR, cloud
gathering, kd-tree Euclidean clustering) runs in C++
(``torchfcn/pointmap/fcn_point_map.cpp``, a copy of the JAX package's);
this module builds the shared library with ``g++`` into
``torchfcn/_build`` at first use (``torchfcn.utils.native``) and wires it
to the port's topic bus with the reference's 4-way approximate-time sync
and topic contract:

  in:  cloud (organized HxWx3 float xyz), mask image, pmap image,
       plane coefficients (passed through: the reference subscribes but
       only uses them for sync)
  out: /output/points  (N, 3) gathered cluster points
       /output/indices list of per-cluster point-index arrays
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional

import numpy as np

from torchfcn.serve.bus import ApproximateTimeSynchronizer, TopicBus

_DIR = Path(__file__).resolve().parent


def build_library(force: bool = False) -> Path:
    """The shared library's path, compiled first if needed (``force``
    rebuilds)."""
    from torchfcn.utils import native
    sources = [_DIR / "fcn_point_map.cpp", _DIR / "fcn_point_map.hpp"]
    if force:
        for old in native.BUILD_DIR.glob("libfcn_point_map-*.so"):
            old.unlink()
    return native.build("libfcn_point_map", sources, shared=True)


class PointMapLib:
    """ctypes wrapper over the C ABI."""

    def __init__(self, path: Optional[str] = None):
        self._lib = ctypes.CDLL(str(path or build_library()))
        self._lib.fcn_point_map_process.restype = ctypes.c_int
        self._lib.fcn_otsu.restype = ctypes.c_int
        self._lib.fcn_region_rects.restype = ctypes.c_int
        self._lib.fcn_euclidean_cluster.restype = ctypes.c_int

    def otsu(self, img: np.ndarray) -> int:
        img = np.ascontiguousarray(img, np.uint8)
        return self._lib.fcn_otsu(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.size)

    def region_rects(self, img: np.ndarray, thresh: int = -1,
                     area_thresh: int = 400, max_rects: int = 256):
        """thresh=-1 -> Otsu (reference regionMask)."""
        img = np.ascontiguousarray(img, np.uint8)
        out = np.zeros((max_rects, 4), np.int32)
        n = self._lib.fcn_region_rects(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            img.shape[0], img.shape[1], thresh, area_thresh, max_rects,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out[:n]

    def euclidean_cluster(self, xyz: np.ndarray, tol: float = 0.02,
                          min_size: int = 100, max_size: int = 25000):
        xyz = np.ascontiguousarray(xyz, np.float32)
        labels = np.zeros(xyz.shape[0], np.int32)
        k = self._lib.fcn_euclidean_cluster(
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            xyz.shape[0], ctypes.c_float(tol), min_size, max_size,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return labels, k

    def process(self, cloud: np.ndarray, mask: np.ndarray,
                pmap: np.ndarray, cluster_tol: float = 0.02,
                min_cluster: int = 100, max_cluster: int = 25000,
                area_thresh: int = 400, keep_matched: bool = True):
        """Full fused pipeline; returns (labels (H, W) int32, n_clusters).

        ``keep_matched=True`` (default) clusters points from object-mask
        regions CONFIRMED by the probability map; ``False`` reproduces the
        reference's XOR-complement polarity (points from the unmatched
        remainder, reference src/fcn_point_map_node.cpp:57-92).
        """
        h, w = mask.shape[:2]
        cloud = np.ascontiguousarray(cloud, np.float32)
        mask = np.ascontiguousarray(mask, np.uint8)
        pmap = np.ascontiguousarray(pmap, np.uint8)
        labels = np.zeros((h, w), np.int32)
        k = self._lib.fcn_point_map_process(
            cloud.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h, w, ctypes.c_float(cluster_tol), min_cluster, max_cluster,
            area_thresh, int(keep_matched),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return labels, k


class PointMapNode:
    """Stream node: 4-way approx-time sync -> C++ pipeline -> publish."""

    def __init__(self, bus: TopicBus,
                 cloud_topic: str = "cloud",
                 mask_topic: str = "mask",
                 pmap_topic: str = "pmap",
                 coef_topic: str = "coefficients",
                 points_topic: str = "/output/points",
                 indices_topic: str = "/output/indices",
                 lib: Optional[PointMapLib] = None,
                 cluster_tol: float = 0.02,
                 min_cluster: int = 100,
                 max_cluster: int = 25000,
                 area_thresh: int = 400,
                 keep_matched: bool = True,
                 slop: float = 0.1):
        self.bus = bus
        self.lib = lib or PointMapLib()
        self.points_topic = points_topic
        self.indices_topic = indices_topic
        self.params = (cluster_tol, min_cluster, max_cluster, area_thresh,
                       keep_matched)
        self.processed = 0
        ApproximateTimeSynchronizer(
            bus, [cloud_topic, mask_topic, pmap_topic, coef_topic],
            self._callback, queue_size=100, slop=slop)

    def _callback(self, cloud_msg, mask_msg, pmap_msg, coef_msg):
        cloud = cloud_msg.data
        labels, k = self.lib.process(cloud, mask_msg.data, pmap_msg.data,
                                     *self.params)
        flat = labels.reshape(-1)
        pts = cloud.reshape(-1, 3)
        sel = flat >= 0
        out_points = pts[sel]
        # indices address the PUBLISHED (compacted) cloud, matching the
        # reference contract (fcn_point_map_node.cpp pushes icounter++
        # over the gathered object_cloud): out_points[indices[c]] are
        # cluster c's points
        compact = flat[sel]
        indices: List[np.ndarray] = [
            np.nonzero(compact == c)[0] for c in range(k)]
        self.bus.publish(self.points_topic, out_points,
                         stamp=cloud_msg.stamp)
        self.bus.publish(self.indices_topic, indices, stamp=cloud_msg.stamp)
        self.processed += 1
