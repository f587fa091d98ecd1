"""Serving and training entry points of the port on a mesh of gloo CPU
ranks.

* ``Detector(mesh=...)`` of ``vgg_detectnet_train`` (64x64, stride 8,
  float32, the heads biased so that NMS has work) on a (data=2) and a
  (data=2, space=2) mesh, against tpufcn's ``Detector(mesh=...)`` on
  ``tests/conftest.py``'s virtual CPU devices and against the port's
  one-device Detector, on the same weights and frames: per image the
  sorted (box, label) lists equal, boxes, labels and valid masks exactly,
  and the confidences (log votes) within 1 float32 ulp (XLA's CPU log, as
  tests/test_torch_detector.py); every rank returns the global result.
* The GoogLeNet DetectNet Detector, row-sharded against one device (the
  port alone): the same exactness.
* A Trainer whose ``cfg.mesh`` is (data=2), on 2 ranks, fed by a
  ``DeviceBatchCache``: each parameter after 3 SGD steps within 1e-4 of
  its leaf's largest move plus 1e-6 of its leaf's largest magnitude of a
  one-device Trainer's on the same global batches (float32: the ranks sum
  the gradients in another order, a bias's gradient sums every pixel's
  with cancellation, and each update rounds the parameter),
  snapshots on rank 0 only, and ``best`` decided by rank 0's validator
  scores on every rank.
* ``torchfcn.cli train --device cpu --device-data`` for 2 steps, with the
  flags of tpufcn's ``train`` (which parses the same command line to the
  same values), writing a snapshot, ``--metrics-out`` and the label
  manifest tpufcn writes for the same manifest; ``train --manifest``
  without ``--device-data`` for 2 steps on the host compositor, its first
  batch tpufcn's for the same manifest and seed; ``--manifest --workers
  2`` through the worker pool, each batch one worker's serial pipeline's;
  ``--records --workers 2`` from the records, no pool started;
  ``--inspect-data``: the first batch's overlay and seg PNGs, tpufcn's for
  the same records (and, within the cubic bound, manifest), and the
  device compositor's first batch drawn by ``torchfcn.serve.viz``.
* ``torchfcn.entry.dryrun_multichip(4)``."""

import dataclasses
import json
import os

import cv2 as cv
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import DetectorConfig as JDetectorConfig
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.core.config import MeshConfig as JMeshConfig
from tpufcn.core.mesh import make_mesh as jmake_mesh
from tpufcn.serve import detector as jax_det
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DetectorConfig, GridConfig, TrainConfig
from torchfcn.data.imageio import imwrite
from torchfcn.parallel.distributed import run_ranks
from torchfcn.serve.detector import Detector
from torchfcn.serve.result import DetectionResult

from test_torch_mesh_ranks import rank_detector, rank_trainer

torch.set_num_threads(2)

NAME, HW = "vgg_detectnet_train", 64
BOX = np.float32([-24, -24, 120, 120])


def _same_detections(got, want):
    got_lists, want_lists = got.to_lists(), want.to_lists()
    assert sum(map(len, got_lists)) > 0
    assert len(got_lists) == len(want_lists)
    for g_img, w_img in zip(got_lists, want_lists):
        g_img, w_img = sorted(g_img), sorted(w_img)
        assert [d[:2] for d in g_img] == [d[:2] for d in w_img]
        np.testing.assert_array_max_ulp(
            np.float32([d[2] for d in g_img]),
            np.float32([d[2] for d in w_img]), maxulp=1)


def _result(parts):
    return DetectionResult(*(torch.as_tensor(np.array(p)) for p in parts))


@pytest.mark.parametrize("data,space", [(2, 1), (2, 2)])
def test_meshed_detector_matches_tpufcn_and_one_device(data, space):
    jgrid = JGridConfig(HW, HW, stride=8, num_classes=2)
    jcfg = JDetectorConfig(grid=jgrid, model=NAME, max_candidates=32)
    jdet = jax_det.Detector(NAME, dtype=jnp.float32, config=jcfg,
                            model_kwargs={"num_classes": 2}, rng_seed=0)
    params = jax.tree.map(np.array, jdet.params)
    params["params"]["cvg/classifier"]["conv"]["bias"][:] = 1.0
    params["params"]["bbox/regressor"]["conv"]["bias"][:] = np.tile(BOX, 2)
    mesh = jmake_mesh(JMeshConfig(data, space),
                      devices=jax.devices("cpu")[:data * space])
    jmesh_det = jax_det.Detector(NAME, dtype=jnp.float32, config=jcfg,
                                 params=jax.tree.map(jnp.asarray, params),
                                 model_kwargs={"num_classes": 2}, mesh=mesh)
    cfg = DetectorConfig(grid=GridConfig(HW, HW, stride=8, num_classes=2),
                         model=NAME, max_candidates=32)
    det = Detector(NAME, config=cfg, dtype=torch.float32, device="cpu",
                   model_kwargs={"num_classes": 2})
    load_jax_params(det.model, params)
    frames = np.random.default_rng(0).integers(
        0, 256, (4, HW, HW, 3)).astype(np.uint8)
    want = jmesh_det(frames)
    one = det(frames)
    got = run_ranks(rank_detector, data * space, NAME, det.model.state_dict(),
                    {"num_classes": 2}, cfg, frames, data, space,
                    torch.float32, threads=1)
    for parts in got:
        res = _result(parts)
        for a, b in zip(res, got[0]):
            assert torch.equal(a, b)        # every rank: the global result
        assert tuple(res.boxes.shape) == tuple(np.asarray(want.boxes).shape)
        _same_detections(res, _result(want))
        _same_detections(res, one)
    # a rank's ValueError comes back as the spawner's exception
    with pytest.raises(Exception, match="ValueError: sharded serving needs "
                                        "batch size divisible by the mesh "
                                        "data axis"):
        run_ranks(rank_detector, data * space, NAME, det.model.state_dict(),
                  {"num_classes": 2}, cfg, frames[:3], data, space,
                  torch.float32, threads=1)


def test_row_sharded_googlenet_detector_matches_one_device():
    """At 128x128 (an 8x8 grid), the heads' weights scaled by 0.1 and
    biased (coverage 8, boxes as above) so that cells fire together."""
    name, hw = "googlenet_detectnet", 128
    cfg = DetectorConfig(grid=GridConfig(hw, hw, stride=16, num_classes=2),
                         model=name, max_candidates=64)
    det = Detector(name, config=cfg, dtype=torch.float32, device="cpu",
                   model_kwargs={"num_classes": 2})
    with torch.no_grad():
        det.model.cvg.weight.mul_(0.1)
        det.model.cvg.bias.fill_(8.0)
        det.model.bbox.weight.mul_(0.1)
        det.model.bbox.bias.copy_(torch.from_numpy(np.tile(BOX, 2)))
    frames = np.random.default_rng(1).integers(
        0, 256, (4, hw, hw, 3)).astype(np.uint8)
    got = run_ranks(rank_detector, 4, name, det.model.state_dict(),
                    {"num_classes": 2}, cfg, frames, 2, 2, torch.float32,
                    threads=1)
    _same_detections(_result(got[0]), det(frames))


def test_detector_refuses_extra_axes():
    class Extra:
        shape = {"data": 1, "space": 1, "model": 2}
    with pytest.raises(ValueError, match="extra non-trivial axes"):
        Detector(NAME, mesh=Extra(), device="cpu")


def _train_batches(n, seed=0, b=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xy = rng.uniform(0, HW * 0.6, (b, 4, 2))
        wh = rng.uniform(6, HW * 0.5, (b, 4, 2))
        out.append({
            "image": rng.integers(0, 256, (b, HW, HW, 3), dtype=np.uint8),
            "rects": np.concatenate([xy, wh], -1).astype(np.float32),
            "labels": rng.integers(0, 2, (b, 4)).astype(np.int32),
            "valid": rng.random((b, 4)) < 0.8})
    return out


def test_trainer_on_a_data_mesh(tmp_path):
    cfg = TrainConfig(grid=GridConfig(HW, HW, 8, 2), model=NAME,
                      optimizer="sgd", learning_rate=0.01, snapshot_every=2,
                      max_iter=3, eval_every=1,
                      snapshot_dir=str(tmp_path / "mesh"), log_every=1)
    batches = _train_batches(2)
    got = run_ranks(rank_trainer, 2, cfg, batches, 2, 1, [0.5, 0.9, 0.7],
                    2, threads=1)
    one_cfg = dataclasses.replace(cfg, snapshot_dir=str(tmp_path / "one"))
    init, want, step, best, snaps, shape = rank_trainer(
        one_cfg, batches, 1, 1, cache=2)
    assert snaps == [2, 3] and shape is None
    for r_init, params, r_step, r_best, r_snaps, shape in got:
        assert r_step == step == 3 and shape == {"data": 2, "space": 1}
        # rank 0's scores (0.5, 0.9, 0.7) decide: best at step 2
        assert r_best == {"step": 2, "score": 0.9, "metric": "mAP"}
        assert r_snaps == [2, 3]          # one directory, written by rank 0
        for k, v in params.items():
            assert torch.equal(r_init[k], init[k])
            move = float((want[k] - init[k]).abs().max())
            size = float(want[k].abs().max())
            assert float((v - want[k]).abs().max()) <= \
                1e-4 * move + 1e-6 * size, k
    with open(tmp_path / "mesh" / "BEST.json") as f:
        assert json.load(f)["metrics"] == {"mAP": 0.9}


def _scene_files(tmp_path):
    rng = np.random.default_rng(0)
    lines, det_lines = [], []
    for i in range(2):
        img, mask = tmp_path / f"crop{i}.png", tmp_path / f"mask{i}.png"
        imwrite(str(img), rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
        m = np.zeros((40, 48, 3), np.uint8)
        m[6:34, 8:40] = 255
        imwrite(str(mask), m)
        lines += [f"{img} {mask} {i + 1} 8 6 32 28", ""]
        det_lines.append(f"{img} 8 6 32 28 {i + 1}")
    bg = tmp_path / "bg.png"
    imwrite(str(bg), rng.integers(0, 256, (224, 224, 3), dtype=np.uint8))
    manifest, val = tmp_path / "train.txt", tmp_path / "val.txt"
    manifest.write_text("\n".join(lines) + "\n")
    val.write_text("\n".join(det_lines) + "\n")
    return str(manifest), str(val), str(bg)


def test_cli_train_writes_snapshot_and_metrics(tmp_path, capsys,
                                               monkeypatch):
    import tpufcn.cli as jcli
    from tpufcn.data.manifest import read_mask_manifest as jread
    from torchfcn import cli
    manifest, val, bg = _scene_files(tmp_path)
    snap, metrics = str(tmp_path / "snap"), str(tmp_path / "m.jsonl")
    argv = ["train", "--recipe", "bounding_box", "--manifest", manifest,
            "--device-data", "--backgrounds", bg, "--max-iter", "2",
            "--batch-size", "2", "--iter-size", "1", "--snapshot-dir", snap,
            "--metrics-out", metrics, "--warmup", "1", "--cache", "1",
            "--eval-every", "2", "--val-manifest", val, "--val-limit", "2"]
    seen = {}
    monkeypatch.setattr(jcli, "_cmd_train", lambda a: seen.update(vars(a)))
    jcli.main(argv)
    cli.main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["trained_to"] == 2 and out["device"] == "cpu"
    assert os.path.isfile(os.path.join(snap, "2.pt"))
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    assert records and records[-1]["step"] == 2 and "val_mAP" in records[-1]
    # tpufcn parses the same command line to the same values
    args = cli_args(cli, argv + ["--device", "cpu"])
    for key, value in seen.items():
        if key != "fn" and key in args:
            assert args[key] == value, key
    # the label manifest tpufcn writes for the same manifest
    labels = os.listdir(os.path.join(snap, "labels"))
    assert len(labels) == 1
    jpath = str(tmp_path / "jlabels.txt")
    jread(manifest, snapshot_label_manifest=jpath)
    with open(os.path.join(snap, "labels", labels[0])) as f, \
            open(jpath) as g:
        assert f.read() == g.read()


def cli_args(cli, argv):
    """The port's parsed arguments of ``argv``, without running them."""
    seen = {}
    real = cli._cmd_train
    cli._cmd_train = lambda a: seen.update(vars(a))
    try:
        cli.main(argv)
    finally:
        cli._cmd_train = real
    return seen


# image values of the first composed batch off by 1 from tpufcn's (the cubic
# upscale of random-noise scenes; 0 read on cv2 5.0, printed with -s)
CLI_CUBIC_VALUES = 30


def _host_training(tmp_path, monkeypatch):
    """``train --manifest`` without --device-data: 2 steps on the CPU from
    the host compositor, its first batch equal to tpufcn's
    CompositeTrainPipeline batch for the same manifest and seed (images
    within 1 at no more than CLI_CUBIC_VALUES values)."""
    from tpufcn import recipes as jrecipes
    from tpufcn.data.manifest import read_mask_manifest as jread
    from tpufcn.data.pipeline import CompositeTrainPipeline as JPipe
    from torchfcn import cli
    from torchfcn.data import pipeline
    manifest, _, bg = _scene_files(tmp_path)
    batches = []
    real = pipeline.CompositeTrainPipeline.batch

    def recorded(self, n):
        batches.append(real(self, n))
        return batches[-1]

    monkeypatch.setattr(pipeline.CompositeTrainPipeline, "batch", recorded)
    snap = str(tmp_path / "snap")
    cli.main(["train", "--device", "cpu", "--manifest", manifest,
              "--backgrounds", bg, "--max-iter", "2", "--batch-size", "2",
              "--snapshot-dir", snap])
    assert os.path.isfile(os.path.join(snap, "2.pt"))
    cfg = jrecipes.get("bounding_box")
    want = JPipe(jread(manifest), cfg.grid, dataclasses.replace(
        cfg.data, batch_size=2), backgrounds=[bg]).batch(2)
    got = batches[0]
    for k in ("rects", "labels", "valid", "seg"):
        assert np.array_equal(got[k], want[k]), k
    d = np.abs(got["image"].astype(int) - want["image"])
    print(f"train --manifest: {int((d > 0).sum())} image values off by 1")
    assert d.max() <= 1 and int((d > 0).sum()) <= CLI_CUBIC_VALUES


def _records_with_workers(tmp_path, capsys, monkeypatch):
    """``train --records --workers 2``: the records train, the workers are
    ignored (no pool starts), as in tpufcn."""
    from torchfcn import cli
    from torchfcn.data import parallel
    _, val, _ = _scene_files(tmp_path)
    prefix = str(tmp_path / "rec" / "ds")
    os.makedirs(os.path.dirname(prefix))
    cli.main(["records", "--manifest", val, "--out", prefix])

    def no_pool(*a, **kw):
        raise AssertionError("--records started a worker pool")

    monkeypatch.setattr(parallel.ParallelCompositePipeline, "__init__",
                        no_pool)
    capsys.readouterr()
    cli.main(["train", "--device", "cpu", "--records", prefix, "--workers",
              "2", "--max-iter", "2", "--batch-size", "2", "--snapshot-dir",
              str(tmp_path / "snap")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["trained_to"] == 2


def _manifest_with_workers(tmp_path, capsys, monkeypatch):
    """``train --manifest --workers 2`` trains from the pool: every batch
    the Trainer takes is, by digest, the next batch of one worker's serial
    CompositeTrainPipeline (seed 1000 * w, the CLI's default seed), and the
    pool's processes are gone when the command returns."""
    from chip_smoke import batch_digest as digest
    from test_torch_parallel import within
    from torchfcn import cli, recipes
    from torchfcn.data import parallel
    from torchfcn.data.manifest import read_mask_manifest
    from torchfcn.data.pipeline import CompositeTrainPipeline
    manifest, _, bg = _scene_files(tmp_path)
    pools, batches = [], []
    real_init, real_get = (parallel.ParallelCompositePipeline.__init__,
                           parallel.ParallelCompositePipeline._get)

    def init(self, *a, **kw):
        pools.append(self)
        real_init(self, *a, **kw)

    def get(self):
        batches.append(real_get(self))
        return batches[-1]

    monkeypatch.setattr(parallel.ParallelCompositePipeline, "__init__", init)
    monkeypatch.setattr(parallel.ParallelCompositePipeline, "_get", get)
    capsys.readouterr()
    within(lambda: cli.main([
        "train", "--device", "cpu", "--manifest", manifest, "--backgrounds",
        bg, "--workers", "2", "--max-iter", "2", "--batch-size", "2",
        "--snapshot-dir", str(tmp_path / "snap")]), 180)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["trained_to"] == 2 and len(pools) == 1 and len(batches) == 2
    assert not any(p.is_alive() for p in pools[0]._procs)
    cfg = recipes.get("bounding_box")
    data = dataclasses.replace(cfg.data, batch_size=2)
    serial = [CompositeTrainPipeline(read_mask_manifest(manifest), cfg.grid,
                                     data, backgrounds=[bg], seed=1000 * w)
              for w in range(2)]
    pending = [digest(p.batch(2)) for p in serial]
    for got in batches:
        w = pending.index(digest(got))
        pending[w] = digest(serial[w].batch(2))


def _read_pngs(d):
    return {f: cv.imread(os.path.join(d, f), cv.IMREAD_UNCHANGED)
            for f in sorted(os.listdir(d))}


def _inspect_data(flags, tmp_path, capsys, monkeypatch):
    """``train --inspect-data``: one JSON line and the first batch as
    ``b0_XX.png`` overlays (+ ``b0_XX_seg.png``).  From records, tpufcn's
    PNGs exactly; from a manifest on the host compositor, tpufcn's within
    its cubic upscale (values off by 1, at most CLI_CUBIC_VALUES); from
    the device compositor, the port's own first batch drawn by
    ``viz.draw_detections`` (its draws are not tpufcn's)."""
    import tpufcn.cli as jcli
    from torchfcn import cli, recipes
    from torchfcn.data.device_compositor import DeviceCompositePipeline
    from torchfcn.data.imageio import imread
    from torchfcn.data.manifest import read_mask_manifest
    from torchfcn.data.raster import resize_linear_u8
    from torchfcn.serve.viz import draw_detections
    manifest, val, bg = _scene_files(tmp_path)
    prefix = str(tmp_path / "rec" / "ds")
    if flags[0] == "--records":
        os.makedirs(os.path.dirname(prefix))
        cli.main(["records", "--manifest", val, "--out", prefix])
    sub = {"r": prefix, "m": manifest}
    argv = ["train", "--backgrounds", bg, "--batch-size", "2",
            "--snapshot-dir", str(tmp_path / "snap")] + [sub.get(f, f)
                                                         for f in flags]
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    capsys.readouterr()
    cli.main([port if a == "d" else a for a in argv] + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    seg = flags[0] == "--manifest"
    assert out == {"inspect_data": port, "images": 2, "with_seg": seg}
    got = _read_pngs(port)
    names = [f"b0_{i:02d}{s}.png" for i in range(2)
             for s in ("", "_seg")[:1 + seg]]
    assert sorted(got) == sorted(names)
    if "--device-data" in flags:
        cfg = recipes.get("bounding_box")
        data = dataclasses.replace(cfg.data, batch_size=2)
        pipe = DeviceCompositePipeline.from_samples(
            read_mask_manifest(manifest), cfg.grid, data, backgrounds=[bg],
            imread=imread, resize=resize_linear_u8, device="cpu",
            seed=cfg.seed)
        batch = {k: v.numpy() for k, v in next(iter(pipe)).items()}
        for i in range(2):
            dets = [([r[0], r[1], r[0] + r[2], r[1] + r[3]], int(l), 1.0)
                    for r, l, v in zip(batch["rects"][i], batch["labels"][i],
                                       batch["valid"][i]) if v]
            assert dets
            assert np.array_equal(got[f"b0_{i:02d}.png"],
                                  draw_detections(batch["image"][i], dets))
            hi = max(int(batch["seg"][i].max()), 1)
            assert np.array_equal(got[f"b0_{i:02d}_seg.png"], (
                batch["seg"][i].astype(np.float32) * (255.0 / hi)).astype(
                np.uint8))
        return
    monkeypatch.setenv("TPUFCN_PLATFORM", "cpu")
    jcli.main([jax_dir if a == "d" else a for a in argv])
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jout == dict(out, inspect_data=jax_dir)
    want = _read_pngs(jax_dir)
    assert sorted(want) == sorted(got)
    off = 0
    for name in names:
        d = np.abs(got[name].astype(int) - want[name])
        off += int((d > 0).sum())
        assert d.max() <= (1 if seg else 0), name
    print(f"train --inspect-data {flags[0]}: {off} values off by 1")
    assert off <= CLI_CUBIC_VALUES


@pytest.mark.parametrize("flags,case", [
    (["--records", "r", "--workers", "2"], "the worker pool"),
    (["--manifest", "m", "--workers", "2"], "the worker pool"),
    (["--manifest"], None),
    (["--manifest", "m", "--device-data", "--inspect-data", "d"], "viz.py"),
    (["--records", "r", "--inspect-data", "d"], "viz.py"),
    (["--manifest", "m", "--inspect-data", "d"], "viz.py"),
])
def test_cli_train_unported_flags_raise(flags, case, tmp_path, capsys,
                                        monkeypatch):
    """``--inspect-data`` writes the first batch's overlays (viz.py's
    cases); ``--records --workers`` trains from the records and
    ``--manifest --workers`` through the worker pool (the pool's cases),
    ``--manifest`` alone on the host compositor."""
    if case == "the worker pool":
        run = _records_with_workers if flags[0] == "--records" \
            else _manifest_with_workers
        run(tmp_path, capsys, monkeypatch)
    elif case is None:
        _host_training(tmp_path, monkeypatch)
    else:
        _inspect_data(flags, tmp_path, capsys, monkeypatch)


def test_cli_train_refuses_a_larger_world(monkeypatch):
    from torchfcn import cli
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="world of 2"):
        cli.main(["train", "--device", "cpu", "--manifest", "m",
                  "--device-data"])


def test_dryrun_multichip():
    from torchfcn.entry import dryrun_multichip
    results = dryrun_multichip(4)
    assert len(results) == 4
    for r in results:
        assert r["mesh"] == {"data": 2, "space": 2}
        assert r["served"] == {"dp": (8, 8), "spatial": (8, 8)}
