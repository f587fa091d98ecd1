"""Row-sharded training of the FCN, pyramid and ResNet-FPN families on
gloo CPU ranks.

* One step of ``resnet_fpn_detectnet`` and of ``fcn8s_bbox`` (with its seg
  loss and the background label offset) on a (data=1, space=2) mesh at
  96x96, whose bands are uneven (64 + 32 rows), against tpufcn's
  ``make_train_step(mesh=MeshConfig(1, 2))`` on ``tests/conftest.py``'s
  virtual CPU devices, from the same float64 parameters and batch (SGD,
  lr 1, so that a parameter's move is its gradient; dropout 0 on both
  sides, whose generators differ): every parameter's move within 1e-5 of
  the largest move of its leaf, the loss, a float32 metric, within rtol
  1e-6.  tpufcn's ResNet-FPN gets a rate-0 ``nn.Dropout`` (its rate is
  fixed) and float64 ``nn.GroupNorm``s patched in for the test, as the
  port's GroupNorm computes in float64 on float64 input: a float32
  GroupNorm's rounding moves a step's gradients by up to 2 % of a leaf's
  largest move (measured between the packages' unsharded steps; with
  both in float64 they agree to 7.6e-7).
* The 2-rank step against the 1-rank step of the port with dropout on
  (every rank draws the global batch's mask): FCN-8s with seg and the VGG
  pyramid (448x448, B = 1) over two SGD steps within 1e-6 of each leaf's
  largest move (float64; the ranks sum a gradient in another order), and
  ResNet-FPN over one step within 1e-5 (its variance, Flax's fast form
  E[x^2] - E[x]^2, cancels), each plus a float32 ulp of a GroupNorm's
  scale and bias, which stay float32 under the float64 policy."""

import numpy as np
import flax.linen as fnn
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
from torchfcn.models import build
from torchfcn.parallel.distributed import run_ranks

from test_torch_mesh_ranks import POLICIES, rank_train

torch.set_num_threads(2)

SGD = dict(optimizer="sgd", learning_rate=1.0, momentum=0.9)
# name: (rows, grid stride, preprocessing, with seg, label offset, classes)
FAMILIES = {
    "resnet_fpn_detectnet": (96, 16, "shift127", False, 0, 2),
    "fcn8s_bbox": (96, 8, "demean", True, 1, 3),
    "vgg_pyramid_detectnet": (448, 16, "demean", False, 0, 2),
}


def _batch(name, b, seed=0, m=6):
    hw, _, _, with_seg, offset, classes = FAMILIES[name]
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, hw * 0.6, (b, m, 2))
    wh = rng.uniform(6, hw * 0.5, (b, m, 2))
    out = {"image": rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8),
           "rects": np.concatenate([xy, wh], -1).astype(np.float32),
           "labels": rng.integers(0, classes - offset,
                                  (b, m)).astype(np.int32),
           "valid": rng.random((b, m)) < 0.8}
    if with_seg:
        out["seg"] = rng.integers(0, classes, (b, hw, hw)).astype(np.int32)
    return out


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("name", ["resnet_fpn_detectnet", "fcn8s_bbox"])
def test_row_sharded_step_matches_tpufcn(name, monkeypatch):
    hw, stride, pre, with_seg, offset, classes = FAMILIES[name]
    batch = _batch(name, 2)
    jkw = {"dropout_rate": 0.0}
    if name.startswith("resnet"):
        drop, norm = fnn.Dropout, fnn.GroupNorm
        monkeypatch.setattr(fnn, "Dropout",
                            lambda rate, **kw: drop(0.0, **kw))
        monkeypatch.setattr(fnn, "GroupNorm", lambda **kw: norm(
            **{**kw, "dtype": jnp.float64, "param_dtype": jnp.float64}))
        jkw = {}
    with jax.enable_x64(True):
        jmodel = jax_build(name, num_classes=classes, dtype=jnp.float64,
                           **jkw)
        params = jax.jit(jmodel.init)(jax.random.key(0),
                                      jnp.zeros((1, hw, hw, 3)))
        params = jax.tree.map(lambda p: np.asarray(p, np.float64), params)
        jcfg = JTrainConfig(grid=JGridConfig(hw, hw, stride, classes),
                            model=name, **SGD)
        state = jstep.TrainState.create(      # the step donates the state
            apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params),
            tx=jstep.make_optimizer(jcfg), dropout_rng=jax.random.key(1))
        mesh = jmake_mesh(JMeshConfig(1, 2), devices=jax.devices("cpu")[:2])
        sh = jstep.batch_sharding(mesh)
        jbatch = {k: jax.device_put(jnp.asarray(v), sh[k])
                  for k, v in batch.items()}
        new, jmetrics = jstep.make_train_step(
            jmodel, jcfg, mesh=mesh, with_seg=with_seg, preprocessing=pre,
            label_offset=offset)(state, jbatch)
        moved = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             new.params, params)
    kwargs = {"num_classes": classes, "dropout_rate": 0.0}
    model = build(name, **kwargs)
    POLICIES["f64"].apply(model)
    load_jax_params(model, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = TrainConfig(grid=GridConfig(hw, hw, stride, classes), model=name,
                      **SGD)
    got = run_ranks(rank_train, 2, name, model.state_dict(), kwargs, cfg,
                    batch, 1, 2, "f64", pre, 1, with_seg, offset, threads=1)
    after, metrics = got[0]
    assert got[1][1] == metrics
    assert all(torch.equal(got[1][0][k], after[k]) for k in after)
    np.testing.assert_allclose(metrics["loss_total"],
                               float(jmetrics["loss_total"]), rtol=1e-6)
    paths = model.flax_paths()
    for pname, p in after.items():
        want = _leaf(moved["params"], paths[pname])
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)             # HWIO -> OIHW
        got_move = (p - before[pname]).numpy()
        scale = float(np.abs(want).max())
        assert float(np.abs(got_move - want).max()) <= 1e-5 * scale, pname


@pytest.mark.parametrize("name,steps,tol", [
    ("fcn8s_bbox", 2, 1e-6),
    ("vgg_pyramid_detectnet", 2, 1e-6),
    ("resnet_fpn_detectnet", 1, 1e-5),
])
def test_row_sharded_step_matches_one_rank_with_dropout(name, steps, tol):
    hw, stride, pre, with_seg, offset, classes = FAMILIES[name]
    model = build(name, num_classes=classes)
    model.init_weights(torch.Generator().manual_seed(0))
    POLICIES["f64"].apply(model)
    state = model.state_dict()
    cfg = TrainConfig(grid=GridConfig(hw, hw, stride, classes), model=name,
                      **{**SGD, "learning_rate": 0.01})
    batch = _batch(name, 1 if hw > 200 else 2, seed=1)
    kwargs = {"num_classes": classes}
    want, wm = rank_train(name, state, kwargs, cfg, batch, 1, 1, "f64", pre,
                          steps, with_seg, offset)
    got = run_ranks(rank_train, 2, name, state, kwargs, cfg, batch, 1, 2,
                    "f64", pre, steps, with_seg, offset, threads=1)
    for after, metrics in got:
        np.testing.assert_allclose(metrics["loss_total"], wm["loss_total"],
                                   rtol=1e-6)
        for k, v in after.items():
            scale = float((want[k] - state[k]).abs().max())
            # plus the rounding of a float32 leaf (GroupNorm's scale and
            # bias stay float32 under the float64 policy, as Flax's)
            ulp = torch.finfo(v.dtype).eps * float(v.abs().max())
            assert float((v - want[k]).abs().max()) <= tol * scale + ulp, k
