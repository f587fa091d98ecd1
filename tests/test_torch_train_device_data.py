"""The port's Trainer fed by its device compositor through a
``DeviceBatchCache``, with a detection validator, against tpufcn's Trainer
with ``steps_per_dispatch = N`` on the same batches and weights.

vgg_detectnet_train at 64x64, 3 classes, dropout 0, B = 2, N = 2 cached
batches, 4 steps, validation every 2 steps over 8 held-out scenes composed
under another seed.  The port runs under ``DTypePolicy.parity()`` (float32,
TF32 off); tpufcn in float32.  The heads are biased so that the validator
finds boxes, and every other held-out image's GT is a shifted copy of the
boxes found there at step 0, so that the mAP is neither 0 nor 1.

Held: the loss of every step within rtol 1e-5 of tpufcn's, and each cached
batch's loss lower on its second pass; the validation
records of the metrics history (steps, mAP and detection count) equal;
``BEST.json`` equal.  tpufcn's own ``detection_validator`` computes in
bf16 only, so its side scores through ``score_detection`` with a float32
Detector, which ``tests/test_torch_validate.py`` holds to the port's.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tpufcn.core.config import DataConfig as JDataConfig
from tpufcn.core.config import DetectorConfig as JDetectorConfig
from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.core.config import TrainConfig as JTrainConfig
from tpufcn.data.pipeline import DeviceBatchCache as JDeviceBatchCache
from tpufcn.models import build as jax_build
from tpufcn.serve import detector as jax_det
from tpufcn.train import validate as jval
from tpufcn.train.trainer import Trainer as JTrainer
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import DataConfig, DetectorConfig, GridConfig, \
    TrainConfig
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.data.device_compositor import CropLibrary, \
    DeviceCompositePipeline
from torchfcn.data.pipeline import DeviceBatchCache
from torchfcn.models import build
from torchfcn.train import validate as tval
from torchfcn.train.trainer import Trainer

torch.set_num_threads(2)

NAME, HW, CLASSES, B, N, STEPS = "vgg_detectnet_train", 64, 3, 2, 2, 4
LOSS_RTOL = 1e-5


def _pipe(seed):
    rng = np.random.default_rng(4)
    imgs, masks, labels = [], [], []
    for i in range(6):
        h, w = int(rng.integers(12, 21)), int(rng.integers(12, 21))
        imgs.append(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        masks.append(np.ones((h, w), np.uint8))
        labels.append(i % CLASSES)
    return DeviceCompositePipeline(
        CropLibrary.from_arrays(imgs, masks, labels),
        rng.uniform(0, 255, (2, HW, HW, 3)), GridConfig(HW, HW, 8, CLASSES),
        DataConfig(batch_size=B, compose_max_trials=16), seed=seed,
        device="cpu")


def _recording(step_fn, losses):
    def step(state, batch):
        state, metrics = step_fn(state, batch)
        losses.extend(np.atleast_1d(np.asarray(metrics["loss_total"])))
        return state, metrics
    return step


def test_trainer_with_device_cache_and_validator_matches_jax(tmp_path):
    kw = dict(model=NAME, max_iter=STEPS, snapshot_every=0, eval_every=N,
              log_every=1)
    jcfg = JTrainConfig(grid=JGridConfig(HW, HW, 8, CLASSES),
                        data=JDataConfig(batch_size=B),
                        snapshot_dir=str(tmp_path / "jax"), **kw)
    cfg = TrainConfig(grid=GridConfig(HW, HW, 8, CLASSES),
                      data=DataConfig(batch_size=B),
                      snapshot_dir=str(tmp_path / "port"), **kw)

    # tpufcn's float32 model and its seeded parameters, heads biased
    jdet = jax_det.Detector(
        NAME, dtype=jnp.float32, model_kwargs={"num_classes": CLASSES},
        config=JDetectorConfig(grid=jcfg.grid, model=NAME,
                               max_candidates=64))
    jtrainer = JTrainer(jcfg, model=jax_build(NAME, dtype=jnp.float32,
                                              num_classes=CLASSES,
                                              dropout_rate=0.0),
                        steps_per_dispatch=N, log_sink=lambda s: None)
    jstate = jtrainer.init_state()
    params = jax.tree.map(np.array, jstate.params)
    params["params"]["cvg/classifier"]["conv"]["bias"][:] = 1.0
    params["params"]["bbox/regressor"]["conv"]["bias"][:] = \
        [-24, -24, 40, 40] * CLASSES
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))

    images, gts, _ = tval.val_set_from_compositor(_pipe(seed=77), 8, batch=4)
    jdet.params = jstate.params
    found = jdet(images.numpy()).to_lists()
    gts = [g if i % 2 else
           (np.asarray([b for b, _, _ in found[i]], np.float64) + 2,
            np.asarray([l for _, l, _ in found[i]], np.int64))
           for i, g in enumerate(gts)]

    def jvalidate(p):
        jdet.params = p
        m, n_det = jval.score_detection(jdet, images.numpy(), gts, CLASSES,
                                        chunk=4)
        return {"mAP": round(m, 4), "n_det": n_det}

    jtrainer.validator = jvalidate
    trainer = Trainer(
        cfg, model=build(NAME, num_classes=CLASSES, dropout_rate=0.0),
        validator=tval.detection_validator(
            NAME, images, gts, model_kwargs={"num_classes": CLASSES},
            chunk=4, config=DetectorConfig(grid=cfg.grid, model=NAME,
                                           max_candidates=64)),
        policy=DTypePolicy.parity(), device="cpu", log_sink=lambda s: None)
    state = trainer.init_state()
    load_jax_params(state.model, params)

    # the port's cache of N composed batches; tpufcn gets the same ones
    cache = DeviceBatchCache(trainer.put, iter(_pipe(seed=5)), N)
    assert all("seg" not in b for b in cache.batches)
    host = iter([{k: v.numpy() for k, v in b.items()}
                 for b in cache.batches])
    jcache = JDeviceBatchCache(jtrainer.put, host, N)

    losses, jlosses = [], []
    trainer.step_fn = _recording(trainer.step_fn, losses)
    jtrainer.step_fn = _recording(jtrainer.step_fn, jlosses)
    state = trainer.fit(iter(cache), state=state, resume=False)
    jtrainer.fit(iter(jcache), state=jstate, resume=False)

    assert state.step == STEPS and len(losses) == len(jlosses) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    # each cached batch comes back every N steps, with a lower loss
    assert losses[2] < losses[0] and losses[3] < losses[1]

    def val(history):
        return [h for h in history if "val_mAP" in h]

    got, want = val(trainer.logger.history), val(jtrainer.logger.history)
    assert [h["step"] for h in got] == [2, 4]
    assert got == want
    assert all(0 < h["val_mAP"] < 1 and h["val_n_det"] > 0 for h in got)
    best = [json.load(open(os.path.join(d, "BEST.json")))
            for d in (cfg.snapshot_dir, jcfg.snapshot_dir)]
    assert best[0] == best[1]
