"""The port's VOC flow end to end on the CPU, on the committed fixture
``tests/fixtures/voc_mini`` (the port's copy of ``tests/test_voc_e2e.py``):

* the CLI chain ``voc -> records --format voc -> records --inspect ->
  train --records (2 steps, B = 4) -> eval --format voc`` with
  ``--device cpu``;
* ``records`` with ``--augment --relabel --background`` writing tpufcn's
  CLI's shards, byte for byte;
* ``eval``'s mAP and per-class AP equal to tpufcn's ``evaluate_detector``
  on the same weights (tpufcn's seeded init with constant coverage and
  bbox heads, carried across with ``convert/from_jax.py``), on the first 8
  val images with half their ground truth replaced by boxes the detector
  finds (so that the APs lie strictly between 0 and 1);
* ``eval --format seg`` printing tpufcn's CLI's JSON line on a mask
  manifest of fixture JPEGs and PNG masks, both CLIs loading one
  ``.caffemodel`` of fcn32s_seg whose score layer is a constant favouring
  class 1;
* ``train --records`` refusing a segmentation-only model;
* ``voc_fixture_gate(steps=4, n_cached=2, batch=2, device="cpu")``:
  tpufcn's result keys, 96 val images and 168 boxes.
"""

import json
import os

import numpy as np
import pytest
import torch

from torchfcn import cli
from torchfcn.data.manifest import (
    DetectionSample, read_voc_manifest, write_voc_manifest)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "voc_mini")
MODEL = "vgg_detectnet_train"


def _port(argv, capsys):
    cli.main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    out = tmp_path_factory.mktemp("man")
    cli.main(["voc", FIXTURE, "--out", str(out), "--classes", "ball",
              "crate", "cone"])
    return out


def test_cli_chain(man, tmp_path, capsys):
    train_txt, val_txt = man / "train.txt", man / "val.txt"
    assert len(train_txt.read_text().splitlines()) == 48
    assert len(val_txt.read_text().splitlines()) == 96
    rec = str(tmp_path / "rec" / "ds")
    assert _port(["records", "--manifest", str(train_txt), "--format", "voc",
                  "--out", rec], capsys) == [f"wrote 48 records to {rec}-*.rec"]
    lines = [json.loads(l) for l in _port(
        ["records", "--inspect", "--limit", "2", "--out", rec], capsys)]
    assert lines[-1] == {"records": 48, "prefix": rec}
    assert all(l["labels"] and l["image"] == [240, 320, 3]
               for l in lines[:-1])
    snap = str(tmp_path / "snap")
    out = json.loads(_port(
        ["train", "--recipe", "bounding_box", "--records", rec,
         "--batch-size", "4", "--max-iter", "2", "--snapshot-dir", snap,
         "--device", "cpu"], capsys)[-1])
    assert out["trained_to"] == 2 and out["device"] == "cpu"
    res = json.loads(_port(
        ["eval", "--manifest", str(val_txt), "--format", "voc", "--model",
         MODEL, "--weights", snap, "--device", "cpu"], capsys)[-1])
    assert res["images"] == 96
    assert set(res["ap"]) == {"0", "1", "2"}
    assert 0.0 <= res["mAP"] <= 1.0


def test_records_cli_writes_tpufcn_shards(man, tmp_path, capsys,
                                          monkeypatch):
    sub = tmp_path / "sub.txt"
    sub.write_text("".join((man / "train.txt").read_text()
                           .splitlines(keepends=True)[:4]))
    flags = ["--manifest", str(sub), "--format", "voc", "--augment",
             "--relabel", "--background"]
    _port(["records", *flags, "--out", str(tmp_path / "p" / "ds")], capsys)
    monkeypatch.setenv("TPUFCN_PLATFORM", "cpu")
    from tpufcn import cli as jcli
    jcli.main(["records", *flags, "--out", str(tmp_path / "j" / "ds")])
    got = sorted(os.listdir(tmp_path / "p"))
    assert got == sorted(os.listdir(tmp_path / "j"))
    assert "ds.labelmap.json" in got and "ds-00000.rec" in got
    for name in got:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_eval_equals_tpufcn_evaluate_detector(man, tmp_path, capsys):
    import jax
    import jax.numpy as jnp

    import tpufcn.models
    from tpufcn.serve import detector as jdet
    from tpufcn.train.evaluate import evaluate_detector
    from torchfcn.convert.from_jax import load_jax_params
    from torchfcn.data.imageio import imread
    from torchfcn.models import build

    jmodel = tpufcn.models.build(MODEL)
    params = jax.tree.map(np.array, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3), jnp.float32)))
    heads = params["params"]
    classes = heads["cvg/classifier"]["conv"]["bias"].shape[0]
    for name in ("cvg/classifier", "bbox/regressor"):
        heads[name]["conv"]["kernel"][:] = 0.0
    heads["cvg/classifier"]["conv"]["bias"][:] = 1.0
    heads["bbox/regressor"]["conv"]["bias"][:] = np.concatenate(
        [[-8 - c, -10, 30 + 2 * c, 44] for c in range(classes)])
    det = jdet.Detector(MODEL)
    det.params = jax.tree.map(jnp.asarray, params)

    # the first 8 val images; even ones keep their ground truth, odd ones
    # get the detector's own boxes of classes 0-2 as theirs
    samples = read_voc_manifest(str(man / "val.txt"))[:8]
    images = [imread(s.image_path) for s in samples]
    for i in range(1, 8, 2):
        found = [(b, l) for b, l, _ in det(images[i][None]).to_lists()[0]
                 if l < 3]
        assert found
        samples[i] = DetectionSample(
            samples[i].image_path,
            np.asarray([[b[0], b[1], b[2] - b[0], b[3] - b[1]]
                        for b, _ in found], np.int32),
            np.asarray([l for _, l in found], np.int32))
    path = str(tmp_path / "val8.txt")
    write_voc_manifest(path, samples)
    gts = []
    for s in read_voc_manifest(path):
        r = np.asarray(s.rects, np.float64)
        gts.append((np.concatenate([r[:, :2], r[:, :2] + r[:, 2:]], 1),
                    np.asarray(s.labels)))
    want = evaluate_detector(det, images, gts, num_classes=classes)

    model = build(MODEL)
    load_jax_params(model, params)
    snap = tmp_path / "snap"
    snap.mkdir()
    torch.save({"step": 0, "params": model.state_dict()}, snap / "0.pt")
    got = json.loads(_port(
        ["eval", "--manifest", path, "--format", "voc", "--model", MODEL,
         "--weights", str(snap), "--device", "cpu"], capsys)[-1])
    assert got["images"] == 8
    assert got["mAP"] == want["mAP"]
    assert got["ap"] == {str(k): v for k, v in want["ap"].items()}
    assert 0.0 < got["mAP"] < 1.0


def test_eval_seg_matches_tpufcn_cli(man, tmp_path, capsys, monkeypatch):
    from torchfcn.convert import export_caffemodel
    from torchfcn.data.imageio import imwrite
    from torchfcn.models import build

    model = build("fcn32s_seg")
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.score_fr_6.weight.zero_()
        model.score_fr_6.bias.zero_()
        model.score_fr_6.bias[1] = 5.0
    weights = str(tmp_path / "seg.caffemodel")
    export_caffemodel(model, weights)
    lines = []
    for i, s in enumerate(read_voc_manifest(str(man / "train.txt"))[:3]):
        x, y, w, h = (int(v) for v in s.rects[0])
        mask = np.zeros((240, 320), np.uint8)
        mask[y:y + h, x:x + w] = 255
        path = str(tmp_path / f"mask{i}.png")
        imwrite(path, mask)
        lines.append(f"{s.image_path} {path} {5 + 4 * (i % 2)} {x} {y} {w} "
                     f"{h}\n\n")
    manifest = tmp_path / "seg.txt"
    manifest.write_text("".join(lines))
    argv = ["eval", "--manifest", str(manifest), "--format", "seg",
            "--model", "fcn32s_seg", "--weights", weights, "--limit", "3"]
    got = json.loads(_port(argv + ["--device", "cpu"], capsys)[-1])
    monkeypatch.setenv("TPUFCN_PLATFORM", "cpu")
    from tpufcn import cli as jcli
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got == want
    assert got["images"] == 3 and 0.0 < got["mean_iou"] < 1.0


def test_train_records_refuses_segmentation_only(tmp_path):
    with pytest.raises(SystemExit, match="segmentation-only"):
        cli.main(["train", "--recipe", "semantic_segmentation", "--records",
                  str(tmp_path / "ds"), "--device", "cpu"])


def test_voc_fixture_gate_smoke(tmp_path):
    from torchfcn.train.gates import voc_fixture_gate
    res = voc_fixture_gate(steps=4, n_cached=2, batch=2, device="cpu",
                           work_root=str(tmp_path))
    assert set(res) == {"mAP", "n_det", "val_images", "n_gt", "convert_s",
                        "compose_s", "train_s", "eval_s"}
    assert res["val_images"] == 96 and res["n_gt"] == 168
    assert 0.0 <= res["mAP"] <= 1.0
