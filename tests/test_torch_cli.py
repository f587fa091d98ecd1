"""The port's CLI serving subcommands (``torchfcn/cli.py``) with
``--device cpu`` on PNG frames, against tpufcn's CLI where it has the same
subcommand.

Both CLIs load one shared ``.caffemodel`` of vgg_detectnet_train whose
coverage and bbox convs have zero weights and biased biases (coverage
sigmoid(1), boxes (-24, -24, 120, 120) from every cell): the heads are the
same constants in tpufcn's bf16 net and the port's whatever the backbone
computes, so the two CLIs' JSON lines must match: boxes, labels and names
exactly, confidences within 1 float32 ulp (XLA's CPU log).  ``detect``,
``replay`` (per frame and ``--micro-batch``) and ``launch`` are compared
so; ``export`` is loaded back and must equal the Detector; ``profile``
(serving and ``--train``) must name operators with their time.

``convert`` of a ``.caffemodel`` must write tpufcn's ``.npz`` (keys, order
and arrays); ``refine`` and ``rank`` over a manifest of PNG frames, with
one VGG16 ``.caffemodel`` for both packages' extractors, must print the
same JSON lines and write the same manifests as tpufcn's.
"""

import json
import os

import cv2 as cv
import numpy as np
import pytest
import torch

from torchfcn import cli
from torchfcn.convert import export_caffemodel
from torchfcn.data.imageio import imwrite
from torchfcn.serve.detector import Detector
from torchfcn.serve.export import load_exported

torch.set_num_threads(2)

MODEL = "vgg_detectnet_train"
BOX = [-24.0, -24.0, 120.0, 120.0]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    det = Detector(MODEL, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        det.model.cvg.weight.zero_()
        det.model.cvg.bias.fill_(1.0)
        det.model.bbox.weight.zero_()
        det.model.bbox.bias.copy_(torch.tensor(BOX).repeat(
            det.grid.num_classes))
    path = str(tmp_path_factory.mktemp("w") / "const_heads.caffemodel")
    export_caffemodel(det.model, path)
    return path


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    paths = []
    for i, hw in enumerate([(224, 224), (224, 224), (180, 260)]):
        p = str(d / f"f{i}.png")
        imwrite(p, rng.integers(0, 256, hw + (3,), dtype=np.uint8), i % 5)
        paths.append(p)
    return paths


def _lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


def _jax_cli(argv, capsys, monkeypatch):
    monkeypatch.setenv("TPUFCN_PLATFORM", "cpu")
    from tpufcn import cli as jcli
    jcli.main(argv)
    return _lines(capsys)


def _port_cli(argv, capsys):
    cli.main(argv + ["--device", "cpu"])
    return _lines(capsys)


def _same_detections(got, want):
    assert [d["image"] for d in got] == [d["image"] for d in want]
    n = 0
    for g, w in zip(got, want):
        key = lambda d: (d["label"], d["box"])      # noqa: E731
        g, w = sorted(g["detections"], key=key), sorted(w["detections"],
                                                        key=key)
        assert [(d["box"], d["label"], d["name"]) for d in g] == \
            [(d["box"], d["label"], d["name"]) for d in w]
        np.testing.assert_array_max_ulp(
            np.float32([d["confidence"] for d in g]),
            np.float32([d["confidence"] for d in w]), 1)
        n += len(g)
    assert n > 0


def test_detect_matches_tpufcn(weights, frames, tmp_path, capsys,
                               monkeypatch):
    manifest = str(tmp_path / "labels.txt")
    with open(manifest, "w") as f:
        f.write("0 bottle\n1 _ cup\n")
    argv = ["detect", *frames, "--model", MODEL, "--weights", weights,
            "--manifest", manifest]
    want = _jax_cli(argv, capsys, monkeypatch)
    got = _port_cli(argv, capsys)
    _same_detections(got, want)
    assert {d["name"] for r in got for d in r["detections"]} >= {"bottle"}


def test_replay_matches_tpufcn(weights, frames, capsys, monkeypatch):
    argv = ["replay", *frames, "--model", MODEL, "--weights", weights]
    want = _jax_cli(argv, capsys, monkeypatch)
    got = _port_cli(argv, capsys)
    assert got == want
    assert got[-1] == {"frames_processed": 3}
    assert sum(r.get("detections", 0) for r in got) > 0

    # the throughput mode stacks frames of one size: the 224x224 pair
    argv = ["replay", *frames[:2], "--model", MODEL, "--weights", weights,
            "--micro-batch", "2"]
    want = _jax_cli(argv, capsys, monkeypatch)[0]
    got = _port_cli(argv, capsys)[0]
    assert got["frames"] == want["frames"] == 2
    assert set(got) == set(want)


def test_launch_matches_tpufcn(weights, frames, tmp_path, capsys,
                               monkeypatch):
    spec = {"fcn_object_detector": {
        "type": "detector",
        "params": {"model": MODEL, "pretrained_weights": weights,
                   "micro_batch": 2},
        "remap": {"image": "image"}}}
    path = str(tmp_path / "graph.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    argv = ["launch", path, "--frames", *frames[:2]]
    want = _jax_cli(argv, capsys, monkeypatch)
    got = _port_cli(argv, capsys)
    assert got == want == [{"nodes": ["fcn_object_detector"],
                            "frames_published": 2,
                            "processed": {"fcn_object_detector": 2}}]


def test_unreadable_frames_are_skipped(weights, frames, tmp_path, capsys):
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    got = _port_cli(["detect", bad, frames[0], "--model", MODEL,
                     "--weights", weights], capsys)
    assert [r["image"] for r in got] == [frames[0]]
    # a camera recording of the first two frames streams as they do
    video = str(tmp_path / "cam.avi")
    w = cv.VideoWriter(video, cv.VideoWriter_fourcc(*"MJPG"), 5.0,
                       (224, 224))
    for path in frames[:2]:
        w.write(cv.imread(path))
    w.release()
    got = _port_cli(["replay", "--video", video, "--model", MODEL,
                     "--weights", weights], capsys)
    assert got[-1] == {"frames_processed": 2}
    assert [r["frame"] for r in got[:-1]] == [0, 1]
    assert all(r["detections"] > 0 for r in got[:-1])
    # an unreadable input gets no overlay either
    out = str(tmp_path / "overlays")
    got = _port_cli(["detect", bad, frames[0], "--model", MODEL, "--weights",
                     weights, "--overlay-dir", out], capsys)
    assert [r["image"] for r in got] == [frames[0]]
    stem = os.path.splitext(os.path.basename(frames[0]))[0]
    assert os.listdir(out) == [f"{stem}_det.png"]


def test_detect_overlay_dir_matches_tpufcn(weights, frames, tmp_path, capsys,
                                          monkeypatch):
    """``detect --overlay-dir``: tpufcn's ``<stem>_det.png`` files, pixel
    for pixel, a second input of the same basename written as
    ``<stem>_1_det.png``."""
    again = tmp_path / "again"
    again.mkdir()
    dup = str(again / os.path.basename(frames[0]))
    with open(frames[0], "rb") as f, open(dup, "wb") as g:
        g.write(f.read())
    inputs = [frames[0], frames[2], dup]
    outs = {}
    for key in ("port", "jax"):
        out = str(tmp_path / key)
        argv = ["detect", *inputs, "--model", MODEL, "--weights", weights,
                "--overlay-dir", out]
        lines = _port_cli(argv, capsys) if key == "port" \
            else _jax_cli(argv, capsys, monkeypatch)
        outs[key] = (lines, {f: cv.imread(os.path.join(out, f))
                             for f in sorted(os.listdir(out))})
    _same_detections(outs["port"][0], outs["jax"][0])
    stem = os.path.splitext(os.path.basename(frames[0]))[0]
    got, want = outs["port"][1], outs["jax"][1]
    assert sorted(got) == sorted(want) == sorted([
        f"{stem}_det.png", f"{stem}_1_det.png",
        os.path.splitext(os.path.basename(frames[2]))[0] + "_det.png"])
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert not np.array_equal(got[f"{stem}_det.png"], cv.imread(frames[0]))


def test_export_loads_back(weights, frames, tmp_path, capsys):
    out = str(tmp_path / "det.pt2")
    got = _port_cli(["export", "--model", MODEL, "--weights", weights,
                     "--batch", "2", "--out", out], capsys)
    assert got == [{"out": out, "bytes": os.path.getsize(out), "batch": 2,
                    "device": "cpu"}]
    det = Detector(MODEL, device="cpu", weights=weights)
    x = torch.from_numpy(np.stack([cv.imread(p) for p in frames[:2]]))
    res = load_exported(open(out, "rb").read())(det.forward_fn()[1], x)
    want = det(x)
    assert all(torch.equal(a, b) for a, b in zip(res, want))
    assert want.valid.any()


@pytest.mark.parametrize("train", [False, True])
def test_profile(capsys, train):
    argv = ["profile", "--model", MODEL, "--batch", "1", "--iters", "1",
            "--json"] + (["--train"] if train else [])
    got = _port_cli(argv, capsys)[0]
    assert got["mode"] == ("train" if train else "serve")
    assert got["device"] == "cpu" and got["total_device_us"] > 0
    names = [o["name"] for o in got["ops"]]
    assert any("conv" in n for n in names)
    assert os.path.isfile(os.path.join(got["logdir"], "trace.json"))


def test_convert_matches_tpufcn(tmp_path, capsys, monkeypatch):
    """``convert`` of one ``.caffemodel`` that names every conv of the
    model: the same ``.npz`` keys, in the same order, and arrays in both
    CLIs; a file that lacks a conv converts only with ``--lenient``."""
    from torchfcn.models import build
    model = build(MODEL)
    model.init_weights(torch.Generator().manual_seed(3))
    path = str(tmp_path / "w.caffemodel")
    export_caffemodel(model, path)
    out = {}
    for tag in ("jax", "port"):
        npz = str(tmp_path / f"{tag}.npz")
        argv = ["convert", path, "--model", MODEL, "--out", npz]
        if tag == "jax":
            monkeypatch.setenv("TPUFCN_PLATFORM", "cpu")
            from tpufcn import cli as jcli
            jcli.main(argv)
        else:
            cli.main(argv)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line == f"wrote {npz} ({len(np.load(npz).files)} arrays)"
        out[tag] = np.load(npz)
    assert out["port"].files == out["jax"].files
    assert "params/backbone/conv1_1/conv/kernel" in out["port"].files
    for k in out["jax"].files:
        a, b = out["port"][k], out["jax"][k]
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), k
    # the .npz loads back into the model through from_jax
    from torchfcn.convert.from_jax import load_jax_params
    again = build(MODEL)
    tree = {}
    for leaf in again.flax_paths().values():
        node = tree
        for part in leaf[:-1]:
            node = node.setdefault(part, {})
        node[leaf[-1]] = out["port"]["/".join(("params",) + leaf)]
    load_jax_params(again, tree)
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                 model.state_dict().values()))
    # a blob that no conv takes converts only with --lenient
    from torchfcn.convert import load_caffemodel, write_caffemodel
    layers = load_caffemodel(path)
    layers["extra"] = [np.ones((2, 3, 3, 3), np.float32)]
    extra = str(tmp_path / "extra.caffemodel")
    write_caffemodel(extra, layers)
    with pytest.raises(KeyError, match="extra"):
        cli.main(["convert", extra, "--model", MODEL, "--out",
                  str(tmp_path / "x.npz")])
    cli.main(["convert", extra, "--model", MODEL, "--out",
              str(tmp_path / "y.npz"), "--lenient"])
    assert capsys.readouterr().out.startswith("wrote ")


def _tool_sequence(tmp_path):
    """A manifest over 10 PNG frames of a textured object moving across
    noise, with two frames of noise alone, and a VGG16 ``.caffemodel`` for
    the tools' extractor."""
    from torchfcn.models.vgg import VGG16Backbone
    rng = np.random.default_rng(2)
    gy, gx = np.mgrid[0:40, 0:30]
    patch = np.stack([30 + gx * 4, 200 - gy * 3, 120 + ((gx + gy) % 7) * 10],
                     axis=-1).clip(0, 255).astype(np.uint8)
    lines = []
    for i in range(10):
        img = rng.integers(0, 60, (120, 160, 3)).astype(np.uint8)
        if i in (4, 7):
            img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
        else:
            img[30 + 2 * i:70 + 2 * i, 40 + 4 * i:70 + 4 * i] = patch
        p = str(tmp_path / f"f{i}.png")
        imwrite(p, img)
        lines.append(f"{p} {38 + 4 * i} {28 + 2 * i} 34 44 1")
    man = str(tmp_path / "train.txt")
    with open(man, "w") as f:
        f.write("\n".join(lines) + "\n")
    backbone = VGG16Backbone()
    backbone.init_weights(torch.Generator().manual_seed(4))
    weights = str(tmp_path / "vgg16.caffemodel")
    export_caffemodel(backbone, weights)
    return man, weights


def test_refine_and_rank_match_tpufcn(tmp_path, capsys, monkeypatch):
    """``refine`` and ``rank`` (both metrics) through both CLIs with one
    VGG16 ``.caffemodel`` at 64 x 64 in bf16: equal JSON lines and equal
    manifests at the default paths next to the input.  The seeded
    backbone's codes of the object's crops lie within 0.01 of each other,
    ten times that from the noise, so a threshold of 0.03 keeps the one
    and drops the other whatever bf16 rounds."""
    man, weights = _tool_sequence(tmp_path)
    common = ["--manifest", man, "--input-size", "64", "--threshold", "0.03",
              "--extractor-weights", weights]
    for argv in (["refine"], ["rank"], ["rank", "--metric", "chi_square"]):
        argv = argv + common
        want = _jax_cli(argv, capsys, monkeypatch)
        want_text = open(want[-1]["out"]).read()
        got = _port_cli(argv, capsys)
        assert got == want
        assert open(got[-1]["out"]).read() == want_text
        if argv[0] == "refine":
            assert got == [{"refined": 10, "out": str(tmp_path /
                                                      "train_refined.txt")}]
        else:
            assert got == [{"kept": 8, "total": 10,
                            "out": str(tmp_path / "train2.txt")}]
