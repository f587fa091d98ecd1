"""The training and serving entry points of the port row-sharded over a
family whose frames split into uneven bands, on gloo CPU ranks.

* The mesh compositor at 96x96 on (data=1, space=2) and (data=2, space=2)
  meshes: the union of the ranks' bands (64 + 32 rows) is the one-device
  batch, bit for bit.
* ``Trainer(cfg)`` with ``cfg.mesh = MeshConfig(1, 2)`` training
  ``fcn8s_bbox`` at 96x96 from a ``DeviceBatchCache``: each parameter after
  3 SGD steps within 1e-6 of its leaf's largest move of a one-device
  Trainer's on the same global batches (float64, dropout on: every rank
  draws the global mask; the ranks sum a gradient in another order).
* A launch graph whose detector node serves ``fcn8s_bbox`` (288x288, the
  bands 160 + 128 rows) with the ``mesh`` param {"data": 1, "space": 2}:
  rank 0's published rects equal a one-process graph's."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from torchfcn.core.config import GridConfig, TrainConfig
from torchfcn.models import build
from torchfcn.parallel.distributed import run_ranks
from torchfcn.serve.launch import launch

from test_torch_mesh_ranks import (
    compositor, rank_compose, rank_launch, rank_trainer)

torch.set_num_threads(2)

HW = 96
RECTS = "/fcn_object_detector/rects"


@pytest.mark.parametrize("data", [1, 2])
def test_mesh_compositor_union_on_uneven_bands(data):
    got = run_ranks(rank_compose, 2 * data, data, 2, 2, HW, threads=1)
    pipe = compositor(hw=HW)
    for i in range(2):
        want = pipe.batch(4)
        for key, value in want.items():
            if key in ("image", "seg"):
                assert [g[i][key].shape[1] for g in got[:2]] == [64, 32]
                union = torch.cat([torch.cat([got[d * 2 + s][i][key]
                                              for s in range(2)], dim=1)
                                   for d in range(data)], dim=0)
            else:
                union = torch.cat([got[d * 2][i][key] for d in range(data)])
            assert torch.equal(union, value), key


def _batches(n, b=4, seed=0):
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


def test_row_sharded_trainer_matches_one_device(tmp_path):
    cfg = TrainConfig(grid=GridConfig(HW, HW, 8, 3), model="fcn8s_bbox",
                      optimizer="sgd", learning_rate=0.01, max_iter=3,
                      snapshot_every=3, snapshot_dir=str(tmp_path / "mesh"),
                      log_every=1)
    batches = _batches(2)
    got = run_ranks(rank_trainer, 2, cfg, batches, 1, 2, None, 2, "f64",
                    threads=1)
    one_cfg = dataclasses.replace(cfg, snapshot_dir=str(tmp_path / "one"))
    init, want, step, _, snaps, shape = rank_trainer(one_cfg, batches, 1, 1,
                                                     cache=2, policy="f64")
    assert snaps == [3] and shape is None
    for r_init, params, r_step, _, r_snaps, shape in got:
        assert r_step == step == 3 and shape == {"data": 1, "space": 2}
        assert r_snaps == [3]
        for k, v in params.items():
            assert torch.equal(r_init[k], init[k])
            move = float((want[k] - init[k]).abs().max())
            assert float((v - want[k]).abs().max()) <= 1e-6 * move, k


def test_meshed_launch_of_a_row_sharded_family(tmp_path):
    """fcn8s_bbox, float32, its heads biased as
    ``torchfcn.serve.profile.bias_heads`` biases them (foreground class 1
    lifted over the background; boxes (-24, -24, 40, 40)), loaded from a
    Trainer snapshot."""
    model = build("fcn8s_bbox", num_classes=3)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.score_pool3.bias[1] = 4.0
        model.score_conv5_bbox.bias.copy_(
            torch.tensor([-24.0, -24.0, 40.0, 40.0]).repeat(3))
    snap = tmp_path / "snap"
    snap.mkdir()
    torch.save({"step": 1, "params": model.state_dict()}, snap / "1.pt")
    spec = {"fcn_object_detector": {
        "type": "detector", "remap": {"image": "image"},
        "params": {"model": "fcn8s_bbox", "num_classes": 3,
                   "device": "cpu", "dtype": "float32",
                   "max_candidates": 64, "micro_batch": 2,
                   "pretrained_weights": str(snap),
                   "mesh": {"data": 1, "space": 2}}}}
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (288, 288, 3)).astype(np.uint8)
              for _ in range(2)]
    got = run_ranks(rank_launch, 2, spec, frames, RECTS, threads=1)
    assert got[1] == 2                # the follower ran rank 0's batch
    one = copy.deepcopy(spec)
    one["fcn_object_detector"]["params"].pop("mesh")
    graph = launch(one)
    want = []
    graph.bus.subscribe(RECTS, lambda m: want.append(
        (m.stamp, m.data.points, m.data.labels)), queue_size=64)
    for i, f in enumerate(frames):
        graph.bus.publish("image", f, stamp=float(i))
        graph.spin()
    graph.close()
    graph.spin()
    assert len(want) == 2 and sum(len(w[2]) for w in want) > 0
    assert sorted(got[0]) == sorted(want)
