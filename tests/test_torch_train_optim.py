"""torchfcn's optimizer and learning-rate schedule against tpufcn's optax
chain: 50 updates of a small parameter tree with the same gradients, for
Adam with step decay and warmup and for SGD with momentum, both with the
L2 weight decay, the parameters within 1e-6 (relative to each tensor's
scale) of optax's."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from tpufcn.core.config import TrainConfig as JTrainConfig
from tpufcn.train.step import make_optimizer as jax_optimizer
from torchfcn.core.config import TrainConfig
from torchfcn.train.step import apply_update, make_optimizer, make_schedule

SHAPES = {"conv": (4, 3, 3, 3), "bias": (4,), "head": (2, 4, 1, 1)}
CONFIGS = {
    "adam_decay_warmup": dict(optimizer="adam", learning_rate=1e-2,
                              lr_decay_step=7, lr_gamma=0.5, warmup_steps=5,
                              weight_decay=1e-2),
    "sgd_momentum": dict(optimizer="sgd", learning_rate=5e-2,
                         lr_decay_step=20, lr_gamma=0.1, momentum=0.9,
                         weight_decay=1e-3),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fifty_updates_match_optax(name):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(50)]
    jcfg = JTrainConfig(**CONFIGS[name])
    tx = jax_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)

    cfg = TrainConfig(**CONFIGS[name])
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    opt = make_optimizer(cfg, tparams.values())
    schedule = make_schedule(cfg)
    for count, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        apply_update(opt, schedule, count)
        for k, p in tparams.items():
            want = np.asarray(jparams[k])
            err = np.abs(p.detach().numpy() - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (name, count, k, err)


def test_schedule_matches_optax():
    cfg = TrainConfig(learning_rate=3e-4, lr_decay_step=4, lr_gamma=0.1,
                      warmup_steps=3)
    jcfg = JTrainConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name in ("learning_rate", "lr_decay_step",
                                         "lr_gamma", "warmup_steps")})
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, jcfg.learning_rate, jcfg.warmup_steps),
         optax.exponential_decay(jcfg.learning_rate, jcfg.lr_decay_step,
                                 jcfg.lr_gamma, staircase=True)],
        [jcfg.warmup_steps])
    ours = make_schedule(cfg)
    for count in range(20):
        np.testing.assert_allclose(ours(count), float(sched(count)),
                                   rtol=1e-6, atol=1e-12)
    assert make_schedule(TrainConfig(lr_decay_step=0))(10 ** 6) == 1e-4
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(TrainConfig(optimizer="rmsprop"),
                       [torch.zeros(1, requires_grad=True)])
