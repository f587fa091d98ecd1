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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["replay", "--video", "x.avi", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["detect", frames[0], "--overlay-dir", str(tmp_path),
                  "--device", "cpu"])


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
