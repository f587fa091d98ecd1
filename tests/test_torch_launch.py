"""The port's launch graphs (``torchfcn/serve/launch.py``) and point-map
node (``torchfcn/pointmap``) against tpufcn's.

* A detector graph on the CPU serves what a Detector with the same weights
  serves: seeded, a ``.caffemodel`` file, a Trainer snapshot directory;
  a missing weights path raises ``FileNotFoundError("PROVIDE PRETRAINED
  MODEL: ...")`` as tpufcn's does.
* Every ``examples/*.launch.json``: its node types resolve and the graph
  builds on the CPU with every param but ``mesh`` (which needs a process
  group of several ranks); a detector's ``overlay_topic`` publishes, under
  each frame's stamp, ``viz.draw_detections`` of the frame and the rects
  the node publishes (weights with biased heads, so that boxes are
  drawn).
* The label tools' node types (capture, boundary_refinement,
  roi_classifier) build on the CPU and run on two synced frames; a
  boundary-refinement and a capture node on one graph publish and write
  what tpufcn's do.
* The multichip example's params, its overlay included, at (data=2,
  space=2) on 4 gloo CPU ranks, rank 0 leading and the others following:
  the rects and overlays it publishes per frame equal a one-device graph's
  on the same weights (a snapshot with biased heads) and frames.
* The topology of ``tests/test_launch_integration.py`` without its capture
  node: a detector and a point-map node on one bus in each package, the
  same frame and synthetic organized cloud published; the processed
  counts equal and the point-map outputs (points, cluster indices)
  identical.
* The port's copy of the C++ point-map library against tpufcn's build on
  the same inputs: Otsu, region rects, clusters and the fused pipeline
  identical.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from tpufcn.pointmap import PointMapLib as JPointMapLib
from tpufcn.serve.launch import launch as jlaunch
from torchfcn.convert import export_caffemodel
from torchfcn.core.config import DataConfig, GridConfig, TrainConfig
from torchfcn.pointmap import PointMapLib
from torchfcn.serve.detector import Detector
from torchfcn.serve.launch import launch
from torchfcn.serve.profile import bias_heads

torch.set_num_threads(2)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
MODEL = "vgg_detectnet_train"
RECTS = "/fcn_object_detector/rects"


def _graph_rects(params, frames):
    graph = launch({"det": {"type": "detector", "params": params,
                            "remap": {"image": "/cam"}}})
    out = []
    graph.bus.subscribe(RECTS, lambda m: out.append(m.data), queue_size=64)
    for i, f in enumerate(frames):
        graph.bus.publish("/cam", f, stamp=float(i))
        graph.spin(2)
    assert graph.nodes["det"].processed == len(frames)
    return out, graph.nodes["det"].detector


def _direct_rects(det, frames):
    lists = det(np.stack(frames)).to_lists()
    return [[p for box, _, _ in dets for p in ((box[0], box[1]),
                                               (box[2], box[3]))]
            for dets in lists], [[lab for _, lab, _ in d] for d in lists]


def _assert_graph_serves(params, want_det, frames):
    got, det = _graph_rects(params, frames)
    points, labels = _direct_rects(want_det, frames)
    assert [m.points for m in got] == points
    assert [m.labels for m in got] == labels
    assert sum(map(len, labels)) > 0
    return det


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
            for _ in range(2)]


@pytest.fixture(scope="module")
def trained_caffemodel(tmp_path_factory):
    """A .caffemodel of seed-3 weights with the heads biased, and the
    Detector that serves them."""
    det = Detector(MODEL, dtype=torch.float32, rng_seed=3, device="cpu",
                   max_candidates=64)
    bias_heads(det)
    path = str(tmp_path_factory.mktemp("w") / "w.caffemodel")
    export_caffemodel(det.model, path)
    return path, det


def test_detector_graph_with_caffemodel(trained_caffemodel, frames):
    path, want = trained_caffemodel
    det = _assert_graph_serves(
        {"model": MODEL, "device": "cpu", "dtype": "float32",
         "max_candidates": 64, "pretrained_weights": path}, want, frames)
    assert det.device.type == "cpu" and det.config.candidate_capacity == 64


def test_detector_graph_with_snapshot(trained_caffemodel, frames, tmp_path):
    from torchfcn.train.trainer import Trainer
    _, want = trained_caffemodel
    cfg = TrainConfig(grid=GridConfig(64, 64, 8, 11), model=MODEL,
                      data=DataConfig(batch_size=2),
                      snapshot_dir=str(tmp_path / "snap"))
    trainer = Trainer(cfg, device="cpu", log_sink=lambda s: None)
    state = trainer.init_state()
    state.model.load_state_dict(want.model.state_dict())
    trainer.save(state)
    _assert_graph_serves(
        {"model": MODEL, "device": "cpu", "dtype": "float32",
         "max_candidates": 64, "pretrained_weights": cfg.snapshot_dir},
        want, frames)


def test_detector_graph_seeded_and_params(frames):
    want = Detector(MODEL, dtype=torch.float32, device="cpu",
                    max_candidates=32)
    got, det = _graph_rects({"model": MODEL, "device": "cpu",
                             "dtype": "float32",
                             "max_candidates": 32, "min_boxes": 2,
                             "nms_eps": 0.3, "detection_threshold": 0.4},
                            frames[:1])
    cfg = det.config
    assert (cfg.min_boxes, cfg.nms_eps, cfg.detection_threshold) == \
        (2, 0.3, 0.4)
    for a, b in zip(det.model.state_dict().values(),
                    want.model.state_dict().values()):
        assert torch.equal(a, b)
    # the node's default device is the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch({"det": {"type": "detector", "params": {"model": MODEL}}})


def test_missing_weights_fail_like_tpufcn(tmp_path):
    missing = str(tmp_path / "nope.caffemodel")
    spec = {"d": {"type": "detector",
                  "params": {"pretrained_weights": missing}}}
    with pytest.raises(FileNotFoundError, match="PROVIDE PRETRAINED MODEL"):
        jlaunch(copy.deepcopy(spec))
    with pytest.raises(FileNotFoundError, match="PROVIDE PRETRAINED MODEL"):
        launch({"d": {"type": "detector",
                      "params": {"pretrained_weights": missing,
                                 "device": "cpu"}}})


def _example(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        return json.load(f)


def _on_cpu(spec):
    for node in spec.values():
        if node.get("type") == "detector":
            node.setdefault("params", {})["device"] = "cpu"
    return spec


# params whose node publishes the overlay (checked below)
OVERLAY_PARAMS = ("overlay_topic",)
# params that need a process group of several ranks (launched below)
MULTI_RANK_PARAMS = ("mesh",)


def _biased_snapshot(path) -> str:
    """A Trainer snapshot of seeded GoogLeNet DetectNet weights whose heads
    are scaled by 0.1 and biased, so that cells fire together."""
    from torchfcn.models import build
    model = build("googlenet_detectnet")
    model.init_weights(torch.Generator().manual_seed(0))
    box = torch.tensor([-24.0, -24.0, 120.0, 120.0]).repeat(4)
    with torch.no_grad():
        model.cvg.weight.mul_(0.1)
        model.cvg.bias.fill_(8.0)
        model.bbox.weight.mul_(0.1)
        model.bbox.bias.copy_(box)
    path.mkdir()
    torch.save({"step": 1, "params": model.state_dict()}, path / "1.pt")
    return str(path)


def rects_as_detections(msg):
    """A RectsMsg back as draw_detections' (box, label, confidence)."""
    pts = msg.points
    return [([*pts[2 * i], *pts[2 * i + 1]], label, conf)
            for i, (label, conf) in enumerate(zip(msg.labels,
                                                  msg.confidences))]


@pytest.mark.parametrize("name,unported", [
    ("empty.launch.json", ()),
    ("fcn_object_detector.launch.json", ("overlay_topic",)),
    ("fcn_object_detector_multichip.launch.json", ("overlay_topic",)),
    ("fcn_point_map.launch.json", ()),
])
def test_example_launch_specs(name, unported, tmp_path):
    """Each example builds on the CPU (``mesh`` taken out); a detector's
    overlay param publishes each frame's overlay under its stamp."""
    from torchfcn.serve.launch import _NODE_TYPES
    from torchfcn.serve.viz import draw_detections
    spec = _on_cpu(_example(name))
    assert all(node["type"] in _NODE_TYPES for node in spec.values())
    found = sorted(p for node in spec.values()
                   for p in node.get("params", {}) if p in OVERLAY_PARAMS)
    assert found == sorted(unported)
    for node in spec.values():
        for p in MULTI_RANK_PARAMS:
            node.get("params", {}).pop(p, None)
    if unported:
        spec["fcn_object_detector"]["params"]["pretrained_weights"] = \
            _biased_snapshot(tmp_path / "snap")
    graph = launch(spec)
    assert sorted(graph.nodes) == sorted(spec)
    for param in unported:
        topic = spec["fcn_object_detector"]["params"][param]
        node = graph.nodes["fcn_object_detector"]
        assert node.overlay_topic == topic
        rects, overlays = [], []
        graph.bus.subscribe(RECTS, rects.append, queue_size=8)
        graph.bus.subscribe(topic, overlays.append, queue_size=8)
        frame = np.random.default_rng(1).integers(
            0, 256, (448, 448, 3)).astype(np.uint8)
        graph.bus.publish("image", frame, stamp=2.5)
        graph.spin()
        graph.close()
        graph.spin()
        assert [m.stamp for m in overlays] == [m.stamp for m in rects] == [2.5]
        dets = rects_as_detections(rects[0].data)
        assert dets
        assert np.array_equal(overlays[0].data,
                              draw_detections(frame, dets, node.names))


def test_multichip_example_on_four_ranks(tmp_path):
    from torchfcn.parallel.distributed import run_ranks
    from test_torch_mesh_ranks import rank_launch
    spec = _on_cpu(_example("fcn_object_detector_multichip.launch.json"))
    params = spec["fcn_object_detector"]["params"]
    overlay = params["overlay_topic"]
    assert overlay and params["mesh"] == {"data": 4, "space": 2}
    params["mesh"] = {"data": 2, "space": 2}
    params["pretrained_weights"] = _biased_snapshot(tmp_path / "snap")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (448, 448, 3)).astype(np.uint8)
              for _ in range(8)]
    got = run_ranks(rank_launch, 4, spec, frames, RECTS, overlay,
                    threads=1)
    assert got[1:] == [8, 8, 8]       # the followers ran rank 0's batch
    one = copy.deepcopy(spec)
    one["fcn_object_detector"]["params"].pop("mesh")
    graph = launch(one)
    want, want_overlays = [], {}
    graph.bus.subscribe(RECTS, lambda m: want.append(
        (m.stamp, m.data.points, m.data.labels)), queue_size=64)
    graph.bus.subscribe(overlay, lambda m: want_overlays.update(
        {m.stamp: m.data}), queue_size=64)
    for i, f in enumerate(frames):
        graph.bus.publish("image", f, stamp=float(i))
        graph.spin()
    graph.close()
    graph.spin()
    assert len(want) == 8 and sum(len(w[2]) for w in want) > 0
    rects, overlays = got[0]
    assert sorted(rects) == sorted(want)
    assert sorted(s for s, _ in overlays) == sorted(want_overlays)
    assert all(np.array_equal(img, want_overlays[s]) for s, img in overlays)
    drawn = [s for s, img in overlays if not np.array_equal(
        img, frames[int(s)])]
    assert drawn                      # boxes were drawn on some frames


def _tool_scene(rng, ox, oy):
    """Noise with a textured 40 x 30 object at (ox, oy)
    (``tests/test_cli_launch.py::test_launch_tool_nodes``'s scene)."""
    img = rng.integers(0, 60, (120, 160, 3)).astype(np.uint8)
    gy, gx = np.mgrid[0:40, 0:30]
    img[oy:oy + 40, ox:ox + 30] = np.stack(
        [30 + gx * 4, 200 - gy * 3, (gx + gy) % 7 * 20],
        axis=-1).clip(0, 255).astype(np.uint8)
    return img


# each tool node type: its params on the CPU, the topics it reads (image,
# then a rect or the detector's rects) and the topic it publishes on
TOOL_NODES = {
    "capture": ({}, "/camera/rgb/image_rect_color", "/object_rect", None),
    "boundary_refinement": ({}, "/camera/rgb/image_rect_color",
                            "/object_rect", "/boundary_refinement/rect"),
    "roi_classifier": ({"device": "cpu", "dtype": "float32",
                        "prob_thresh": 0.0}, "image", RECTS,
                       "/rcnn_detector/rects"),
}


@pytest.mark.parametrize("ntype", ["capture", "boundary_refinement",
                                   "roi_classifier"])
def test_tool_node_types_build_and_run(ntype, tmp_path):
    """The label tools' node types build on the CPU and run on two synced
    frames; an unknown type raises KeyError."""
    from torchfcn.serve.stream import RectsMsg
    params, image, rect, out = TOOL_NODES[ntype]
    params = dict(params, out_dir=str(tmp_path / "cap"))
    graph = launch({"n": {"type": ntype, "params": params}})
    got = []
    if out:
        graph.bus.subscribe(out, got.append)
    rng = np.random.default_rng(0)
    for t, (ox, oy) in enumerate([(40, 30), (46, 34)]):
        graph.bus.publish(image, _tool_scene(rng, ox, oy), stamp=float(t))
        box = [40, 30, 30, 40]
        graph.bus.publish(rect, box if ntype != "roi_classifier" else
                          RectsMsg([(40, 30), (70, 70)], [0], [0.9]),
                          stamp=float(t))
        graph.spin()
    graph.spin()
    if ntype == "capture":
        assert graph.nodes["n"].processed == 2
        assert sorted(os.listdir(tmp_path / "cap")) == [
            "00000000.jpg", "00000001.jpg", "train.txt"]
    elif ntype == "boundary_refinement":
        assert [m.stamp for m in got] == [1.0]
        x, y, _, _ = got[0].data
        assert abs(x - 46) <= 3 and abs(y - 34) <= 3
    else:
        assert [m.stamp for m in got] == [0.0, 1.0]
        assert all(m.data.points == [(40, 30), (70, 70)] for m in got)
    with pytest.raises(KeyError):
        launch({"n": {"type": "no_such_node"}})


def test_launch_tool_nodes_matches_tpufcn(tmp_path):
    """``tests/test_cli_launch.py::test_launch_tool_nodes`` in both
    packages: a boundary-refinement node and a capture node on one graph,
    two synced frames; the tracked rect and the captured files equal."""
    out = {}
    for tag, make in (("port", launch), ("jax", jlaunch)):
        cap = str(tmp_path / tag)
        params = {"out_dir": cap}
        graph = make({
            "boundary_refinement": {"type": "boundary_refinement"},
            "writer": {"type": "capture", "params": params},
        })
        got = []
        graph.bus.subscribe("/boundary_refinement/rect", got.append)
        rng = np.random.default_rng(1)
        for t, (ox, oy) in enumerate([(40, 30), (46, 34)]):
            graph.bus.publish("/camera/rgb/image_rect_color",
                              _tool_scene(rng, ox, oy), stamp=float(t))
            graph.bus.publish("/object_rect", [40, 30, 30, 40],
                              stamp=float(t))
            graph.spin()
        graph.spin()
        files = {n: open(os.path.join(cap, n), "rb").read()
                 for n in sorted(os.listdir(cap))}
        files["train.txt"] = files["train.txt"].replace(cap.encode(), b"")
        out[tag] = ([(m.stamp, list(m.data)) for m in got], files)
    assert out["port"] == out["jax"]
    (stamp, (x, y, w, h)), = out["port"][0]
    assert abs(x - 46) <= 3 and abs(y - 34) <= 3
    assert len(out["port"][1]) == 3


def _cloud(h=48, w=64):
    cloud = np.zeros((h, w, 3), np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cloud[..., 0] = xs * 0.01
    cloud[..., 1] = ys * 0.01
    cloud[..., 2] = 1.0
    cloud[40:, :8] = np.nan                      # invalid points
    cloud[10:20, 30:50, 2] = 1.5                 # a second surface
    mask = np.zeros((h, w), np.uint8)
    mask[8:40, 8:56] = 255
    return cloud, mask


def _run_topology(launch_fn, frame, detector_params):
    graph = launch_fn({
        "fcn_object_detector": {
            "type": "detector", "params": detector_params,
            "remap": {"image": "/camera/rgb/image_rect_color",
                      "pmap": "/fcn_object_detector/pmap"}},
        "fcn_point_map": {
            "type": "point_map",
            "params": {"cluster_tolerance": 0.03, "min_cluster_size": 100},
            "remap": {"cloud": "/camera/depth/points",
                      "mask": "/object_mask",
                      "pmap": "/fcn_object_detector/pmap_mono",
                      "coefficients": "/plane_coefficients"}},
    })
    graph.bus.publish("/camera/rgb/image_rect_color", frame, stamp=0.0)
    graph.spin(2)
    cloud, mask = _cloud()
    got = {}
    graph.bus.subscribe("/output/indices",
                        lambda m: got.setdefault("idx", m.data), queue_size=4)
    graph.bus.subscribe("/output/points",
                        lambda m: got.setdefault("pts", m.data), queue_size=4)
    graph.bus.publish("/camera/depth/points", cloud, stamp=1.0)
    graph.bus.publish("/object_mask", mask, stamp=1.01)
    graph.bus.publish("/fcn_object_detector/pmap_mono", mask.copy(),
                      stamp=1.02)
    graph.bus.publish("/plane_coefficients", None, stamp=1.03)
    graph.spin(3)
    return ({k: n.processed for k, n in graph.nodes.items()},
            got["pts"], got["idx"])


def test_detector_and_pointmap_graph_matches_jax(frames):
    j = _run_topology(jlaunch, frames[0],
                      {"model": MODEL, "max_candidates": 32})
    t = _run_topology(launch, frames[0],
                      {"model": MODEL, "max_candidates": 32, "device": "cpu"})
    assert t[0] == j[0] == {"fcn_object_detector": 1, "fcn_point_map": 1}
    np.testing.assert_array_equal(t[1], j[1])
    assert len(t[2]) == len(j[2]) >= 2
    for a, b in zip(t[2], j[2]):
        np.testing.assert_array_equal(a, b)


def test_pointmap_library_matches_jax():
    lib, jlib = PointMapLib(), JPointMapLib()
    rng = np.random.default_rng(0)
    img = np.concatenate([rng.normal(60, 10, 3000), rng.normal(190, 12, 2000)
                          ]).clip(0, 255).astype(np.uint8).reshape(50, 100)
    assert lib.otsu(img) == jlib.otsu(img)
    for thresh in (-1, 100):
        np.testing.assert_array_equal(lib.region_rects(img, thresh, 40),
                                      jlib.region_rects(img, thresh, 40))
    xyz = np.concatenate([rng.normal(0, 0.004, (300, 3)),
                          rng.normal(0, 0.004, (250, 3)) + 1.0,
                          np.full((5, 3), 5.0)]).astype(np.float32)
    for a, b in zip(lib.euclidean_cluster(xyz, 0.02, 100, 25000),
                    jlib.euclidean_cluster(xyz, 0.02, 100, 25000)):
        np.testing.assert_array_equal(a, b)
    cloud, mask = _cloud()
    pmap = np.zeros_like(mask)
    pmap[12:38, 12:48] = 180
    for keep in (True, False):
        got = lib.process(cloud, mask, pmap, 0.03, 100, 25000, 400, keep)
        want = jlib.process(cloud, mask, pmap, 0.03, 100, 25000, 400, keep)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_stream_modules_import_without_jax_or_cv2():
    """The stream surface imports no JAX, tpufcn or cv2 when they cannot be
    imported at all; ``torchfcn.serve.netbus`` alone imports neither torch
    (a light publisher process) nor the model zoo."""
    import subprocess
    import sys
    repo = os.path.dirname(EXAMPLES)
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'tpufcn', 'cv2'):\n"
            "    sys.modules[m] = None\n"
            "import torchfcn.serve.netbus\n"
            "assert 'torch' not in sys.modules\n"
            "import torchfcn.serve.export\n"
            "assert 'torchfcn.models' not in sys.modules\n"
            "import torchfcn.serve.bus, torchfcn.serve.stream\n"
            "import torchfcn.serve.launch, torchfcn.pointmap\n"
            "import torchfcn.data.imageio, torchfcn.utils.profiling\n"
            "import torchfcn.entry, torchfcn.cli\n"
            "torchfcn.cli.main(['launch', '--help'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          timeout=120, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "--bus" in proc.stdout
