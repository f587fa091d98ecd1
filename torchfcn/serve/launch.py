"""Launch-style node-graph wiring of the port (``tpufcn/serve/launch.py``).

The reference wires topics and rosparams through launch files.  The
graph is a declarative dict, nodes with params and topic remappings,
resolved onto one TopicBus (or a ``RemoteTopicBus`` across processes):

    graph = launch({
        "fcn_object_detector": {
            "type": "detector",
            "params": {"model": "googlenet_detectnet",
                        "detection_threshold": 0.5,
                        "min_boxes": 3, "nms_eps": 0.2,
                        "pretrained_weights": "snapshot.caffemodel"},
            "remap": {"image": "/camera/rgb/image_rect_color"},
        },
        "fcn_point_map": {"type": "point_map", "params": {...}},
    })
    graph.bus.publish(...); graph.spin()

The detector node and the tool nodes' CNN codes run on the card unless
their params say ``"device": "cpu"``.  A detector's ``overlay_topic``
publishes each frame's overlay, drawn on the host
(``torchfcn.serve.viz``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

from torchfcn.serve.bus import TopicBus


@dataclasses.dataclass
class LaunchGraph:
    bus: TopicBus
    nodes: Dict[str, Any]

    def spin(self, n: int = 1):
        for _ in range(n):
            self.bus.spin_once()

    def close(self) -> None:
        """End the stream: flush the nodes and release the ranks that follow
        a meshed detector node."""
        for node in self.nodes.values():
            end = getattr(node, "close", None) or getattr(node, "flush", None)
            if end is not None:
                end()


def _dtype(params: Dict[str, Any]):
    import torch
    name = params.get("dtype", "bfloat16")
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _make_detector(bus: TopicBus, params: Dict[str, Any],
                   remap: Dict[str, str]):
    """A DetectorNode from the params tpufcn's launch files take, plus
    ``device`` ("cuda" by default, or "cpu") and ``dtype`` (a torch dtype
    name, "bfloat16" by default).  Without ``pretrained_weights`` the
    weights are the seeded Caffe "xavier" init.  ``mesh`` ({"data": N,
    "space": M}, ``tpufcn/serve/launch.py:103-117``) serves through
    ``Detector(mesh=make_mesh(MeshConfig(N, M)))``: every rank of the
    process group builds the graph (the group is joined from torchrun's
    environment on ``device`` when it does not exist yet); rank 0's node
    leads and the others follow (``DetectorNode.follow``)."""
    from torchfcn.core.config import DetectorConfig
    from torchfcn.models import get_spec
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.stream import DetectorNode, TiledSegmenter

    model_name = params.get("model", "googlenet_detectnet")
    spec = get_spec(model_name)
    mkw = {}
    grid = spec.grid
    if "num_classes" in params:
        mkw["num_classes"] = int(params["num_classes"])
        grid = dataclasses.replace(grid, num_classes=mkw["num_classes"])
    cfg = DetectorConfig(
        grid=grid,
        detection_threshold=params.get("detection_threshold", 0.5),
        min_boxes=params.get("min_boxes", 3),
        nms_eps=params.get("nms_eps", 0.2),
        model=model_name,
        # None = full grid capacity (every above-threshold cell feeds NMS,
        # like the reference)
        max_candidates=params.get("max_candidates"))
    device = params.get("device", "cuda")
    dtype = _dtype(params)

    weights = params.get("pretrained_weights")
    mode = params.get("mode", "boxes")
    if weights and not os.path.isfile(weights) \
            and not os.path.isdir(weights):
        # the reference kills the node when model files are missing
        raise FileNotFoundError(f"PROVIDE PRETRAINED MODEL: {weights}")
    detector = None
    tiled = None
    if mode == "tiled":
        # the tiled mode serves through the segmenter alone; the box model's
        # weights are not its own
        tiled = TiledSegmenter(params.get("seg_model", "fcn32s_seg"),
                               prob_thresh=cfg.detection_threshold,
                               stride=params.get("tile_stride", 1),
                               dtype=dtype, device=device)
    else:
        mesh = None
        if params.get("mesh"):
            from torchfcn.core.config import MeshConfig
            from torchfcn.core.mesh import make_mesh
            from torchfcn.parallel.distributed import initialize_distributed
            m = params["mesh"]
            initialize_distributed(device=device)
            mesh = make_mesh(MeshConfig(data=int(m.get("data", 1)),
                                        space=int(m.get("space", 1))))
        # a .caffemodel file or a Trainer snapshot directory
        # (torchfcn.convert.resolve_weights)
        detector = Detector(model_name, config=cfg, dtype=dtype,
                            max_candidates=cfg.candidate_capacity,
                            model_kwargs=mkw, device=device,
                            weights=weights or None, mesh=mesh)
    # label manifest -> class display names; like the reference, a missing
    # file falls back to generated names
    names = None
    manifest = params.get("manifest")
    if manifest:
        if os.path.isfile(manifest):
            from torchfcn.data.manifest import read_label_names
            names = read_label_names(manifest)
        else:
            logging.getLogger(__name__).warning(
                "label manifest %s not found; using object_<i> names",
                manifest)
    return DetectorNode(
        bus, detector=detector, mode=mode, tiled=tiled,
        names=names,
        overlay_topic=params.get("overlay_topic"),
        micro_batch=int(params.get("micro_batch", 1)),
        flush_after_ms=(float(params["flush_after_ms"])
                        if "flush_after_ms" in params else None),
        image_topic=remap.get("image", "image"),
        rects_topic=remap.get("rects", "/fcn_object_detector/rects"),
        pmap_topic=remap.get("pmap", "/fcn_object_detector/pmap"))


def _make_point_map(bus: TopicBus, params: Dict[str, Any],
                    remap: Dict[str, str]):
    from torchfcn.pointmap import PointMapNode
    return PointMapNode(
        bus,
        cloud_topic=remap.get("cloud", "cloud"),
        mask_topic=remap.get("mask", "mask"),
        pmap_topic=remap.get("pmap", "pmap"),
        coef_topic=remap.get("coefficients", "coefficients"),
        cluster_tol=params.get("cluster_tolerance", 0.02),
        min_cluster=params.get("min_cluster_size", 100),
        max_cluster=params.get("max_cluster_size", 25000),
        area_thresh=params.get("rect_thresh", 400))


def _make_capture(bus: TopicBus, params: Dict[str, Any],
                  remap: Dict[str, str]):
    from torchfcn.tools.capture import ImageRectWriter
    return ImageRectWriter(
        bus, out_dir=params.get("out_dir", "capture"),
        label=params.get("label", 1),
        image_topic=remap.get("image", "/camera/rgb/image_rect_color"),
        rect_topic=remap.get("rect", "/object_rect"))


def _make_boundary_refinement(bus: TopicBus, params: Dict[str, Any],
                              remap: Dict[str, str]):
    from torchfcn.tools.boundary_refinement import (
        BoundaryRefiner, BoundaryRefinerNode)
    return BoundaryRefinerNode(
        bus,
        refiner=BoundaryRefiner(
            similarity_thresh=params.get("similarity_distance", 0.5)),
        image_topic=remap.get("image", "/camera/rgb/image_rect_color"),
        rect_topic=remap.get("rect", "/object_rect"),
        out_topic=remap.get("out", "/boundary_refinement/rect"))


def _make_roi_classifier(bus: TopicBus, params: Dict[str, Any],
                         remap: Dict[str, str]):
    """Without a pre-built ``classifier``, a random head over seeded CNN
    codes on ``device`` in ``dtype``."""
    from torchfcn.tools.features import CnnCodeExtractor
    from torchfcn.tools.roi_classifier import ROIClassifier, ROIClassifierNode
    clf = params.get("classifier")  # pre-built (e.g. fit_head-trained)
    if clf is None:
        clf = ROIClassifier(num_classes=int(params.get("num_classes", 2)),
                            extractor=CnnCodeExtractor(
                                dtype=_dtype(params),
                                device=params.get("device", "cuda")),
                            prob_thresh=params.get("prob_thresh", 0.5))
    return ROIClassifierNode(
        bus, clf,
        image_topic=remap.get("image", "image"),
        rects_topic=remap.get("rects", "/fcn_object_detector/rects"),
        out_topic=remap.get("out", "/rcnn_detector/rects"))


_NODE_TYPES = {
    "detector": _make_detector,
    "point_map": _make_point_map,
    "capture": _make_capture,
    "boundary_refinement": _make_boundary_refinement,
    "roi_classifier": _make_roi_classifier,
}


def launch(config: Dict[str, Dict[str, Any]],
           bus: Optional[TopicBus] = None) -> LaunchGraph:
    bus = bus or TopicBus()
    nodes = {}
    for name, spec in config.items():
        ntype = spec.get("type")
        if ntype not in _NODE_TYPES:
            raise KeyError(f"unknown node type '{ntype}' for '{name}'")
        nodes[name] = _NODE_TYPES[ntype](
            bus, spec.get("params", {}), spec.get("remap", {}))
    return LaunchGraph(bus=bus, nodes=nodes)
