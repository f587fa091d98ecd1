"""torchfcn's train step against tpufcn's on the same weights and batches.

A ``parity()`` step (float32, dropout 0) of ``vgg_detectnet_train`` at
64x64 and of ``googlenet_detectnet`` at 64x64: the loss and its terms
within rtol 1e-5 of tpufcn's float32 step.  The same step computed in
float64 on both sides: every gradient, mapped through ``flax_paths()``,
within 1e-5 of the largest magnitude of the JAX gradient it is compared
with.  Then ``iter_size = 2`` against tpufcn's scan, and ``fcn8s_bbox``
with its seg head and ``label_offset = 1``, both in float64.

The gradients are compared in float64 because a max pool routes its
gradient to the largest value of each window: where two values of a
window lie within float32 rounding of each other, two float32
implementations that sum in other orders may route it to different
positions, and the gradients of every conv below that pool then differ by
far more than rounding.  At these sizes such near-ties (top-two gaps of
1e-8 to 1e-6 of the activations' scale) occur in most batches; float64
rounding lies far below any of them.  The heads and losses stay float32
in both packages."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.core.config import TrainConfig as JTrainConfig
from tpufcn.models import build as jax_build
from tpufcn.train import step as jstep
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import GridConfig, TrainConfig
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.models import build
from torchfcn.train import step as tstep

torch.set_num_threads(2)

HW, BATCH, M = 64, 2, 6
GRAD_RTOL = 1e-5
F64 = DTypePolicy(param_dtype=torch.float64, compute_dtype=torch.float64)


def _batch(rng, classes, with_seg=False):
    xy = rng.uniform(0, HW * 0.6, (BATCH, M, 2))
    wh = rng.uniform(6, HW * 0.5, (BATCH, M, 2))
    batch = {"image": rng.integers(0, 256, (BATCH, HW, HW, 3),
                                   dtype=np.uint8),
             "rects": np.concatenate([xy, wh], -1).astype(np.float32),
             "labels": rng.integers(0, classes, (BATCH, M)).astype(np.int32),
             "valid": rng.random((BATCH, M)) < 0.8}
    if with_seg:
        batch["seg"] = rng.integers(0, classes + 1, (BATCH, HW, HW)).astype(
            np.int32)
    return batch


def _setup(name, classes, stride, policy=DTypePolicy.parity(), **cfg_kw):
    """JAX model + float32 params and the port's model with the same
    parameters under ``policy``, the JAX model computing in its compute
    dtype; both configs."""
    jdtype = {torch.float32: jnp.float32,
              torch.float64: jnp.float64}[policy.compute_dtype]
    jmodel = jax_build(name, num_classes=classes, dropout_rate=0.0,
                       dtype=jdtype)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, HW, HW, 3), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    model = build(name, num_classes=classes, dropout_rate=0.0)
    policy.apply(model)
    load_jax_params(model, params)
    model.to(memory_format=torch.channels_last)
    jcfg = JTrainConfig(grid=JGridConfig(HW, HW, stride, classes), model=name,
                        **cfg_kw)
    cfg = TrainConfig(grid=GridConfig(HW, HW, stride, classes), model=name,
                      **cfg_kw)
    return jmodel, params, model, jcfg, cfg


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _check_grads(model, jgrads, grads):
    paths = model.flax_paths()
    assert sorted(grads) == sorted(paths)
    for name, g in grads.items():
        want = _leaf(jgrads["params"], paths[name])
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)             # HWIO -> OIHW
        scale = float(np.abs(want).max())
        err = float(np.abs(g.detach().numpy() - want).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


def _jax_grads(jmodel, params, jcfg, batch, preprocessing, iter_size=1,
               **kw):
    loss_fn = jstep.make_loss_fn(jmodel, jcfg, preprocessing=preprocessing,
                                 **kw)
    grads_fn = jax.jit(jstep.make_grads_fn(loss_fn, iter_size))
    return grads_fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.key(1))


def _step(model, cfg, policy, batch, preprocessing):
    """One make_train_step step of ``model`` under ``policy`` from a fresh
    optimizer; returns the metrics (the gradients stay in .grad)."""
    state = tstep.TrainState(
        model=model, optimizer=tstep.make_optimizer(cfg, model.parameters()),
        generator=torch.Generator().manual_seed(0), policy=policy)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = tstep.make_train_step(cfg, preprocessing=preprocessing)
    state, metrics = step(state, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    assert state.step == 1
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert moved, "the update moved no parameter"
    return metrics


@pytest.mark.parametrize("name,classes,stride,preprocessing", [
    ("vgg_detectnet_train", 3, 8, "demean"),
    ("googlenet_detectnet", 4, 16, "shift127"),
])
def test_parity_step_matches_jax(name, classes, stride, preprocessing):
    rng = np.random.default_rng(3)
    batch = _batch(rng, classes)
    jmodel, params, model, jcfg, cfg = _setup(name, classes, stride)
    _, jmetrics = _jax_grads(jmodel, params, jcfg, batch, preprocessing)
    metrics = _step(model, cfg, DTypePolicy.parity(), batch, preprocessing)
    for key in ("loss_total", "loss_bbox", "loss_coverage"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), rtol=1e-5)
    with jax.enable_x64(True):
        jmodel, params, model, jcfg, cfg = _setup(name, classes, stride, F64)
        jgrads, jmetrics = _jax_grads(jmodel, params, jcfg, batch,
                                      preprocessing)
    metrics = _step(model, cfg, F64, batch, preprocessing)
    np.testing.assert_allclose(float(metrics["loss_total"]),
                               float(jmetrics["loss_total"]), rtol=1e-5)
    # the step leaves its gradients in .grad
    _check_grads(model, jgrads, {k: p.grad for k, p in
                                 model.named_parameters()})


def test_iter_size_matches_jax_scan():
    """iter_size = 2: the mean of the two micro-batches' gradients and
    metrics, against tpufcn's ``lax.scan`` accumulation (float64)."""
    rng = np.random.default_rng(4)
    micro = [_batch(rng, 3) for _ in range(2)]
    stacked = tstep.stack_batches(micro)
    assert stacked["image"].shape == (2, BATCH, HW, HW, 3)
    with jax.enable_x64(True):
        jmodel, params, model, jcfg, cfg = _setup(
            "vgg_detectnet_train", 3, 8, F64, iter_size=2)
        jgrads, jmetrics = _jax_grads(jmodel, params, jcfg, stacked,
                                      "demean", iter_size=2)
    grads_fn = tstep.make_grads_fn(tstep.make_loss_fn(cfg), 2)
    grads, metrics = grads_fn(model, {k: torch.as_tensor(v)
                                      for k, v in stacked.items()},
                              torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(metrics["loss_total"]),
                               float(jmetrics["loss_total"]), rtol=1e-5)
    _check_grads(model, jgrads, grads)


def test_multi_train_step_is_a_loop_of_steps():
    """make_multi_train_step on a stacked (N, B, ...) batch leaves the
    model, step and generator where N make_train_step calls leave them,
    and stacks the metrics per step; it refuses iter_size > 1."""
    cfg = TrainConfig(grid=GridConfig(HW, HW, 8, 3))
    rng = np.random.default_rng(6)
    batches = [{k: torch.as_tensor(v) for k, v in _batch(rng, 3).items()}
               for _ in range(2)]
    states = [tstep.init_state(build(cfg.model, num_classes=3), cfg,
                               device="cpu", policy=DTypePolicy.parity())
              for _ in range(2)]
    step = tstep.make_train_step(cfg)
    for b in batches:
        states[0], last = step(states[0], b)
    multi = tstep.make_multi_train_step(cfg)
    states[1], metrics = multi(states[1], tstep.stack_batches(batches))
    assert states[0].step == states[1].step == 2
    assert metrics["loss_total"].shape == (2,)
    assert torch.equal(metrics["loss_total"][-1], last["loss_total"])
    for (name, a), b in zip(states[0].model.named_parameters(),
                            states[1].model.parameters()):
        assert torch.equal(a, b), name
    assert torch.equal(states[0].generator.get_state(),
                       states[1].generator.get_state())
    with pytest.raises(ValueError, match="iter_size"):
        tstep.make_multi_train_step(dataclasses.replace(cfg, iter_size=2))


def test_fcn8s_seg_with_label_offset_matches_jax():
    """fcn8s_bbox trains its detection and seg heads together, object ids
    shifted past the background channel; float64 compute on both sides
    (the heads and losses stay float32, as in the JAX package)."""
    rng = np.random.default_rng(5)
    batch = _batch(rng, 3, with_seg=True)
    with jax.enable_x64(True):
        jmodel, params, model, jcfg, cfg = _setup("fcn8s_bbox", 4, 8, F64)
        jgrads, jmetrics = _jax_grads(jmodel, params, jcfg, batch, "demean",
                                      with_seg=True, label_offset=1)
    loss_fn = tstep.make_loss_fn(cfg, with_seg=True, label_offset=1)
    grads, metrics = tstep.make_grads_fn(loss_fn)(
        model, {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    assert set(metrics) == set(jmetrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-5)
    _check_grads(model, jgrads, grads)
    with pytest.raises(ValueError, match="no 'seg' masks"):
        loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()
                        if k != "seg"}, torch.Generator())
