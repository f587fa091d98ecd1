"""Data-parallel and row-sharded training of the port on gloo CPU ranks.

* One step of ``vgg_detectnet_train`` at 64x64 on a (data=2) and a
  (data=2, space=2) mesh against tpufcn's ``make_train_step(mesh=...)`` on
  ``tests/conftest.py``'s virtual CPU devices, from the same float64
  parameters and batch (SGD, lr 1, so that a parameter's move is its
  gradient; dropout 0 on both sides, whose generators differ): every
  parameter's move within 1e-5 of the largest move of its leaf, both
  packages computing in float64 (a float32 max pool may route a gradient
  to another element of a near-tied window, see test_torch_train_step.py).
* The N-rank port step against the 1-rank port step with dropout on (every
  rank draws the global batch's mask): each parameter's move over two SGD
  steps (lr 0.01) within 1e-6 of the largest move of its leaf, float64 (the
  ranks sum a gradient in another order, and a bias's gradient is a sum
  with cancellation), and the loss, a float32 metric in both packages,
  within rtol 1e-6.
* The mesh compositor: the union of the ranks' batches equals the
  one-device batch, bit for bit.
* ``shard_batch`` and ``Trainer.put(stacked=True)``: each rank's share of
  a global and of a stacked batch."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.core.config import MeshConfig as JMeshConfig
from tpufcn.core.config import TrainConfig as JTrainConfig
from tpufcn.core.mesh import make_mesh as jmake_mesh
from tpufcn.models import build as jax_build
from tpufcn.train import step as jstep
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import GridConfig, TrainConfig
from torchfcn.core.mesh import Mesh
from torchfcn.models import build
from torchfcn.parallel.distributed import LocalBatch, run_ranks, shard_batch
from torchfcn.train.step import stack_batches

from test_torch_mesh_ranks import (
    POLICIES, compositor, rank_compose, rank_train)

torch.set_num_threads(2)

HW, B, M, NAME = 64, 4, 6, "vgg_detectnet_train"
SGD = dict(optimizer="sgd", learning_rate=1.0, momentum=0.9)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, HW * 0.6, (B, M, 2))
    wh = rng.uniform(6, HW * 0.5, (B, M, 2))
    return {"image": rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8),
            "rects": np.concatenate([xy, wh], -1).astype(np.float32),
            "labels": rng.integers(0, 2, (B, M)).astype(np.int32),
            "valid": rng.random((B, M)) < 0.8}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("data,space", [(2, 1), (2, 2)])
def test_sharded_step_matches_tpufcn(data, space):
    batch = _batch()
    with jax.enable_x64(True):
        jmodel = jax_build(NAME, num_classes=2, dropout_rate=0.0,
                           dtype=jnp.float64)
        params = jax.jit(jmodel.init)(jax.random.key(0),
                                      jnp.zeros((1, HW, HW, 3)))
        params = jax.tree.map(lambda p: np.asarray(p, np.float64), params)
        jcfg = JTrainConfig(grid=JGridConfig(HW, HW, 8, 2), model=NAME,
                            **SGD)
        state = jstep.TrainState.create(      # the step donates the state
            apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params),
            tx=jstep.make_optimizer(jcfg), dropout_rng=jax.random.key(1))
        mesh = jmake_mesh(JMeshConfig(data, space),
                          devices=jax.devices("cpu")[:data * space])
        sh = jstep.batch_sharding(mesh)
        jbatch = {k: jax.device_put(jnp.asarray(v), sh[k])
                  for k, v in batch.items()}
        new, jmetrics = jstep.make_train_step(jmodel, jcfg, mesh=mesh)(
            state, jbatch)
        moved = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             new.params, params)
    model = build(NAME, num_classes=2, dropout_rate=0.0)
    POLICIES["f64"].apply(model)
    load_jax_params(model, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = TrainConfig(grid=GridConfig(HW, HW, 8, 2), model=NAME, **SGD)
    got = run_ranks(rank_train, data * space, NAME, model.state_dict(),
                    {"num_classes": 2, "dropout_rate": 0.0}, cfg, batch,
                    data, space, "f64", "demean", threads=1)
    after, metrics = got[0]
    for _, other in got[1:]:
        assert other == metrics
    for r in got[1:]:
        assert all(torch.equal(r[0][k], after[k]) for k in after)
    np.testing.assert_allclose(metrics["loss_total"],
                               float(jmetrics["loss_total"]), rtol=1e-6)
    paths = model.flax_paths()
    for name, p in after.items():
        want = _leaf(moved["params"], paths[name])
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)             # HWIO -> OIHW
        got_move = (p - before[name]).numpy()
        scale = float(np.abs(want).max())
        assert float(np.abs(got_move - want).max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("name,stride,pre", [
    ("vgg_detectnet_train", 8, "demean"),
    ("googlenet_detectnet", 16, "shift127"),
])
def test_n_rank_step_matches_one_rank_with_dropout(name, stride, pre):
    model = build(name, num_classes=2)
    model.init_weights(torch.Generator().manual_seed(0))
    POLICIES["f64"].apply(model)
    state = model.state_dict()
    cfg = TrainConfig(grid=GridConfig(HW, HW, stride, 2), model=name,
                      **{**SGD, "learning_rate": 0.01})
    batch = _batch(1)
    want, wm = rank_train(name, state, {"num_classes": 2}, cfg, batch, 1, 1,
                          "f64", pre, 2)
    got = run_ranks(rank_train, 4, name, state, {"num_classes": 2}, cfg,
                    batch, 2, 2, "f64", pre, 2, threads=1)
    for after, metrics in got:
        np.testing.assert_allclose(metrics["loss_total"], wm["loss_total"],
                                   rtol=1e-6)
        for k, v in after.items():
            move = want[k] - state[k]
            scale = float(move.abs().max())
            assert float((v - want[k]).abs().max()) <= 1e-6 * scale, k


def test_mesh_compositor_union_is_the_one_device_batch():
    got = run_ranks(rank_compose, 4, 2, 2, threads=1)
    pipe = compositor()
    for i in range(2):
        want = pipe.batch(4)
        for key, value in want.items():
            if key in ("image", "seg"):
                union = torch.cat([torch.cat([got[d * 2 + s][i][key]
                                              for s in range(2)], dim=1)
                                   for d in range(2)], dim=0)
            else:
                union = torch.cat([got[d * 2][i][key] for d in range(2)])
                for d in range(2):      # the space ranks agree
                    assert torch.equal(got[d * 2 + 1][i][key],
                                       got[d * 2][i][key])
            assert torch.equal(union, value), key


def test_shard_batch_keeps_each_ranks_share():
    batch = _batch(2)
    stacked = stack_batches([batch, _batch(3)])
    for rank in range(4):
        mesh = Mesh(2, 2, rank, {"mesh": None, "data": None, "space": None},
                    "cpu")
        d, s = divmod(rank, 2)
        bs, rs = slice(2 * d, 2 * d + 2), slice(32 * s, 32 * s + 32)
        share = shard_batch(batch, mesh)
        assert isinstance(share, LocalBatch)
        np.testing.assert_array_equal(share["image"], batch["image"][bs, rs])
        np.testing.assert_array_equal(share["rects"], batch["rects"][bs])
        many = shard_batch(stacked, mesh, stacked=True)
        assert many["image"].shape == (2, 2, 32, HW, 3)
        np.testing.assert_array_equal(many["valid"], stacked["valid"][:, bs])
        assert shard_batch(share, mesh) is share
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({k: v[:3] for k, v in batch.items()}, mesh)
    # Trainer.put on one device: nothing is sliced
    from torchfcn.train.trainer import Trainer
    cfg = dataclasses.replace(TrainConfig(grid=GridConfig(HW, HW, 8, 2)))
    tr = Trainer(cfg, device="cpu", log_sink=lambda s: None)
    assert tr.put(stacked, stacked=True)["image"].shape == (2, B, HW, HW, 3)
