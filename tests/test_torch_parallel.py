"""The port's worker pool (``torchfcn/data/parallel.py::
ParallelCompositePipeline``) and ``train --workers`` against tpufcn's serial
pipelines, on the CPU.

A pool's batches arrive in the order its workers finish them, so it is held
by worker: each batch received must be, by digest, the next batch of
exactly one of the port's serial ``CompositeTrainPipeline(seed + 1000 *
w)``, and that worker's batch from tpufcn's serial pipeline of the same
seed must equal it but for the cubic upscale (at most ``CUBIC_VALUES``
values off by 1 in a batch of 2 scenes at 64x64: ROADMAP Queue 3 item 2).
tpufcn's own pool is not spawned: it imports JAX in every worker.

Every read from a pool goes through ``within``, which fails the test after
``DEADLINE_S`` seconds instead of blocking the run.  One pool serves the
stream and close cases; the Trainer and failure cases start their own.
"""

import multiprocessing as mp
import os
import threading
import time

import cv2 as cv
import numpy as np
import pytest
import torch

from chip_smoke import batch_digest as digest
from tpufcn.core.config import DataConfig as JDataConfig
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.data.manifest import read_mask_manifest as jread
from tpufcn.data.pipeline import CompositeTrainPipeline as JPipe
from torchfcn.core.config import DataConfig, GridConfig
from torchfcn.data import parallel
from torchfcn.data.manifest import MaskSample, read_mask_manifest
from torchfcn.data.parallel import ParallelCompositePipeline
from torchfcn.data.pipeline import CompositeTrainPipeline

torch.set_num_threads(2)

DEADLINE_S = 60.0
HW, B, WORKERS, DEPTH, SEED = 64, 2, 2, 2, 5
# batches read from the pool: at least BATCHES, and EACH from each worker
BATCHES, EACH, MAX_BATCHES = 6, 2, 400
# image values of one batch (2 scenes at 64x64) off by 1 from tpufcn's (the
# cubic upscale; at most 1 read on cv2 5.0 over this file's batches,
# printed with -s; the other worker's batch, the control, differs at about
# 24,500)
CUBIC_VALUES = 30


def within(fn, seconds=DEADLINE_S):
    """``fn()`` in a daemon thread; the test fails if it has not returned
    after ``seconds`` (a pool that blocks), and re-raises its error."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:      # noqa: BLE001 -- re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"{fn} blocked for more than {seconds} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """Two crops with masks and a background as PNGs, and their mask
    manifest (tpufcn's layout)."""
    root = tmp_path_factory.mktemp("pool_scenes")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(2):
        img, mask = root / f"crop{i}.png", root / f"mask{i}.png"
        cv.imwrite(str(img), rng.integers(0, 256, (40, 48, 3),
                                          dtype=np.uint8))
        m = np.zeros((40, 48, 3), np.uint8)
        m[6:34, 8:40] = 255
        cv.imwrite(str(mask), m)
        lines += [f"{img} {mask} {i + 1} 8 6 32 28", ""]
    bg = root / "bg.png"
    cv.imwrite(str(bg), rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
    manifest = root / "train.txt"
    manifest.write_text("\n".join(lines) + "\n")
    return str(manifest), [str(bg)], str(root)


def _grid():
    return GridConfig(im_width=HW, im_height=HW, stride=8, num_classes=2)


def _serial(scene_files, w):
    """Worker ``w``'s serial pipelines: the port's and tpufcn's."""
    manifest, bgs, _ = scene_files
    port = CompositeTrainPipeline(
        read_mask_manifest(manifest), _grid(), DataConfig(batch_size=B),
        backgrounds=bgs, box_capacity=4, seed=SEED + 1000 * w)
    jax = JPipe(jread(manifest), JGridConfig(im_width=HW, im_height=HW,
                                             stride=8, num_classes=2),
                JDataConfig(batch_size=B), backgrounds=bgs, box_capacity=4,
                seed=SEED + 1000 * w)
    return port, jax


@pytest.fixture(scope="module")
def pool_run(scene_files):
    """One pool (2 workers, depth 2), read until each worker has sent EACH
    batches and BATCHES are read (at most MAX_BATCHES: a worker that
    starts late finds the queue filled by the other), then closed.  Returns
    the batches, for each the workers whose next serial batch it equals by
    digest, the pool's processes and the seconds close took."""
    manifest, bgs, _ = scene_files
    serial = [_serial(scene_files, w)[0] for w in range(WORKERS)]
    pending = [digest(p.batch(B)) for p in serial]
    batches, owners = [], []
    pool = ParallelCompositePipeline(
        read_mask_manifest(manifest), _grid(), DataConfig(batch_size=B),
        backgrounds=bgs, box_capacity=4, workers=WORKERS, depth=DEPTH,
        seed=SEED)
    try:
        it = iter(pool)
        while len(batches) < MAX_BATCHES:
            batches.append(within(lambda: next(it)))
            owners.append([w for w in range(WORKERS)
                           if pending[w] == digest(batches[-1])])
            if len(owners[-1]) != 1:
                break
            w = owners[-1][0]
            pending[w] = digest(serial[w].batch(B))
            if len(batches) >= BATCHES and all(
                    owners.count([v]) >= EACH for v in range(WORKERS)):
                break
    finally:
        t = time.perf_counter()
        within(pool.close)
        close_s = time.perf_counter() - t
    return batches, owners, list(pool._procs), close_s


def _values_off(a, b) -> int:
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max() <= 1
    return int((d > 0).sum())


def test_pool_streams_match_serial_pipelines(pool_run, scene_files):
    batches, owners, _, _ = pool_run
    assert all(len(o) == 1 for o in owners), owners
    owners = [o[0] for o in owners]
    assert all(owners.count(w) >= EACH for w in range(WORKERS)), owners
    jax = [_serial(scene_files, w)[1] for w in range(WORKERS)]
    for i, (got, w) in enumerate(zip(batches, owners)):
        assert got["image"].shape == (B, HW, HW, 3)
        assert got["rects"].shape == (B, 4, 4) and got["valid"].any()
        want = jax[w].batch(B)
        for k in ("rects", "labels", "valid", "seg"):
            assert np.array_equal(got[k], want[k]), (i, k)
        off = _values_off(got["image"], want["image"])
        print(f"batch {i} from worker {w}: {off} image values off by 1 "
              f"from tpufcn's")
        assert off <= CUBIC_VALUES
    # the control: the other worker's first batch breaks the bound
    other = _serial(scene_files, 1 - owners[0])[1].batch(B)
    control = int((batches[0]["image"] != other["image"]).sum())
    print(f"the other worker's batch: {control} image values differ")
    assert control > CUBIC_VALUES


def test_pool_close_leaves_no_children(pool_run):
    _, _, procs, close_s = pool_run
    assert len(procs) == WORKERS
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)
    live = {c.pid for c in mp.active_children()}
    assert not live & {p.pid for p in procs}
    assert close_s < parallel.JOIN_S + 5


def test_pool_relays_a_worker_error(tmp_path):
    """A data error in a worker (a missing file) reaches the consumer as a
    RuntimeError with the worker's traceback."""
    bad = [MaskSample(str(tmp_path / "missing.png"),
                      str(tmp_path / "missing_mask.png"), 0,
                      np.array([1, 1, 8, 8], np.int32))]
    grid = GridConfig(im_width=32, im_height=32, stride=8, num_classes=2)
    with ParallelCompositePipeline(bad, grid, DataConfig(batch_size=1),
                                   workers=1, depth=2, seed=0) as pool:
        with pytest.raises(RuntimeError,
                           match="scene-builder worker failed") as e:
            within(pool.batch)
    assert "Traceback" in str(e.value) and "missing" in str(e.value)
    assert not any(p.is_alive() for p in pool._procs)


def test_pool_whose_workers_exited_raises(scene_files, monkeypatch):
    """Workers that all exit (here killed before their first batch) make
    the consumer raise instead of block."""
    monkeypatch.setattr(parallel, "POLL_S", 0.5)
    manifest, bgs, _ = scene_files
    pool = ParallelCompositePipeline(
        read_mask_manifest(manifest), _grid(), DataConfig(batch_size=B),
        backgrounds=bgs, workers=2, depth=2, seed=SEED)
    for p in pool._procs:
        p.kill()
        p.join()
    try:
        with pytest.raises(RuntimeError, match="workers exited"):
            within(pool.batch)
    finally:
        pool.close()


def test_trainer_fit_from_pool(tmp_path, scene_files):
    """The Trainer consumes the pool end to end (tpufcn's
    tests/test_trainer.py::test_trainer_fit_from_parallel_pipeline)."""
    from torchfcn.core.config import TrainConfig
    from torchfcn.models import build
    from torchfcn.train.trainer import Trainer
    manifest, bgs, _ = scene_files
    cfg = TrainConfig(grid=_grid(), model="vgg_detectnet_train",
                      data=DataConfig(batch_size=2), snapshot_every=0,
                      max_iter=2, snapshot_dir=str(tmp_path / "snap"),
                      log_every=1)
    tr = Trainer(cfg, model=build("vgg_detectnet_train", num_classes=2),
                 device="cpu", log_sink=lambda s: None)
    with ParallelCompositePipeline(
            read_mask_manifest(manifest), cfg.grid, cfg.data,
            backgrounds=bgs, box_capacity=4, workers=2, depth=2,
            seed=SEED) as pool:
        state = within(lambda: tr.fit(iter(pool), max_iter=2), 120)
    assert int(state.step) == 2


def test_cli_device_data_with_workers_exits(scene_files):
    from torchfcn import cli
    manifest, bgs, root = scene_files
    with pytest.raises(SystemExit, match="--device-data"):
        cli.main(["train", "--device", "cpu", "--manifest", manifest,
                  "--device-data", "--workers", "2", "--snapshot-dir",
                  os.path.join(root, "snap_exit")])
