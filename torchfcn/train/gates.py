"""The tracked accuracy gates of the port (``tpufcn/train/gates.py``): each
model family trained on the hard synthetic benchmark
(``torchfcn.data.hardbench``) and scored on a held-out set, exact and with
its e5m2 serving preset on the same parameters; and the ``voc_fixture``
gate, the reference's own data flow on the committed VOC fixture (VOC
converter -> record shards -> training -> held-out mAP).

Every e5m2 and structural decision is gated on these trained readings, not
on output parity.  As in the JAX package, a gate trains by default on a
fixed set of scenes composed by the host compositor and cached on disk
(``data_mode="host_cached"``; ``"host"`` composes them in every run) and
scores on the host-composed held-out set (``build_eval_set``), so that one
seed trains and scores on the JAX package's scenes.  ``data_mode="device"``
composes the training scenes with the device compositor and scores on a
device-composed held-out set (``build_device_eval_set``): the JAX package
measured device-composed training scenes 0.04-0.12 mAP below host-composed
ones on its host-composed held-out set.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from torchfcn.core.config import DataConfig, GridConfig, TrainConfig
from torchfcn.data.hardbench import (
    build_device_eval_set, build_eval_set, eval_cache_path,
    hard_device_pipeline, hard_pipeline)

DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "torchfcn_hardgate")
VOC_WORK_ROOT = os.path.join(tempfile.gettempdir(), "torchfcn_vocgate")
# the committed VOC fixture, tests/fixtures/voc_mini of the repository
VOC_FIXTURE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "fixtures", "voc_mini")
FIXTURE_CLASSES = ("ball", "crate", "cone")
VOC_GRID = GridConfig(224, 224, stride=8, num_classes=11)
VOC_EVAL_HW = (448, 448)


def _hard_trainer(model_name: str, grid: GridConfig, root: str, *,
                  steps: int, batch: int, seed: int, with_seg: bool,
                  model_kwargs: Optional[dict], lr: float = 3e-4,
                  warmup: int = 0, device="cuda"):
    """The gates' Trainer: Adam at ``lr`` times 0.3 from ``steps // 2`` on,
    the default policy (float32 parameters, bf16 convolutions), the
    initial parameters seeded by ``seed``."""
    from torchfcn.models import build
    from torchfcn.train.trainer import Trainer
    cfg = TrainConfig(
        grid=grid, model=model_name, data=DataConfig(batch_size=batch),
        optimizer="adam", learning_rate=lr,
        lr_decay_step=max(steps // 2, 1), lr_gamma=0.3,
        warmup_steps=warmup, max_iter=steps, snapshot_every=0,
        snapshot_dir=os.path.join(root, f"snap_{model_name}_{seed}"),
        log_every=10 ** 9, seed=seed)
    return Trainer(cfg, model=build(model_name, **(model_kwargs or {})),
                   with_seg=with_seg, log_sink=lambda s: None, device=device)


# Scene-cache format version: raise it whenever hard_pipeline or the host
# compositor changes the bytes it composes for a given (geometry, classes,
# batch, n, seed) key, which the key alone cannot see.  Version 1 keeps the
# JAX package's unversioned name; later versions append ``_v{N}``.
SCENE_CACHE_VERSION = 1
DATA_MODES = ("host_cached", "host", "device")


def train_cache_path(root: str, grid: GridConfig, *, classes: int,
                     batch: int, n_cached: int, seed: int) -> str:
    """Where a gate's host-composed training scenes are cached (the JAX
    package's name)."""
    tag = (f"hard_train_{grid.im_height}x{grid.im_width}_s{grid.stride}"
           f"_c{classes}_b{batch}_n{n_cached}_seed{seed}")
    if SCENE_CACHE_VERSION > 1:
        tag += f"_v{SCENE_CACHE_VERSION}"
    return os.path.join(root, tag + ".npz")


def _cached_host_batches(root: str, grid: GridConfig, *, classes: int,
                         batch: int, n_cached: int, seed: int, log=None):
    """The gate's fixed training scenes: ``n_cached`` batches of
    ``hard_pipeline(seed=seed)``, composed once on the host and cached at
    ``train_cache_path`` (seg maps stored as uint8).  Returns the batches
    as dicts of numpy.  ``log``: progress lines (default stderr)."""
    if log is None:
        log = lambda m: print(m, file=sys.stderr)   # noqa: E731
    path = train_cache_path(root, grid, classes=classes, batch=batch,
                            n_cached=n_cached, seed=seed)
    if not os.path.isfile(path):
        t0 = time.time()
        pipe = hard_pipeline(root, grid, batch_size=batch, seed=seed,
                             classes=classes)
        batches = [pipe.batch(batch) for _ in range(n_cached)]
        arrs = {}
        for k in batches[0]:
            stacked = np.stack([b[k] for b in batches])
            if k == "seg":       # labels <= classes + 1: store compactly
                stacked = stacked.astype(np.uint8)
            arrs[k] = stacked
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **arrs)
        os.replace(tmp, path)    # no reader sees a half-written file
        log(f"gate host-batch cache: composed {os.path.basename(path)} "
            f"in {time.time() - t0:.0f}s")
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files}
    n = arrs["image"].shape[0]
    return [{k: (v[i].astype(np.int32) if k == "seg" else v[i])
             for k, v in arrs.items()} for i in range(n)]


def _train_hard(model_name: str, grid: GridConfig, root: str, *,
                classes: int, steps: int, batch: int, n_cached: int,
                seed: int, with_seg: bool, model_kwargs: Optional[dict],
                lr: float = 3e-4, weights: Optional[str] = None,
                data_mode: str = "host_cached", warmup: int = 0, log=None,
                device="cuda"):
    """Train ``model_name`` on the hard benchmark (``_hard_trainer``) from a
    ``DeviceBatchCache`` of ``n_cached`` batches of scenes seeded with
    ``1000 + seed``; returns the final ``TrainState``.  ``seed`` varies both
    the initial parameters and the scenes.  ``weights``: a ``.caffemodel``
    (e.g. the VGG16 pretrain) loaded leniently by name over the seeded
    init.  ``data_mode``, where the scenes come from (the JAX package's
    three):

    * "host_cached" (the default): the host compositor, cached on disk
      (``_cached_host_batches``), so only the first run composes them;
    * "host": the host compositor in every run;
    * "device": the device compositor on ``device``."""
    from torchfcn.convert import resolve_weights
    from torchfcn.data.pipeline import DeviceBatchCache

    if data_mode not in DATA_MODES:
        raise ValueError(f"data_mode={data_mode!r}: one of {DATA_MODES}")
    trainer = _hard_trainer(model_name, grid, root, steps=steps, batch=batch,
                            seed=seed, with_seg=with_seg,
                            model_kwargs=model_kwargs, lr=lr, warmup=warmup,
                            device=device)
    if data_mode == "host_cached":
        src = iter(_cached_host_batches(root, grid, classes=classes,
                                        batch=batch, n_cached=n_cached,
                                        seed=1000 + seed, log=log))
    elif data_mode == "host":
        src = iter(hard_pipeline(root, grid, batch_size=batch,
                                 seed=1000 + seed, classes=classes))
    else:
        src = iter(hard_device_pipeline(root, grid, batch_size=batch,
                                        seed=1000 + seed, classes=classes,
                                        device=device))
    cache = DeviceBatchCache(trainer.put, src, n_batches=n_cached)
    state = trainer.init_state()
    if weights:
        resolve_weights(weights, state.model)
    return trainer.fit(iter(cache), max_iter=steps, state=state,
                       resume=False)


def held_out_set(root: str, grid: GridConfig, classes: int, n_images: int,
                 data_mode: str = "host_cached", device="cuda"):
    """The gate's held-out set: the host-composed one (``build_eval_set``)
    for the host modes, the device-composed one for "device"."""
    if data_mode == "device":
        return build_device_eval_set(root, grid, classes=classes,
                                     n_images=n_images, device=device)
    return build_eval_set(root, grid, classes=classes, n_images=n_images)


def _score_detector(model_name: str, params, grid: GridConfig, images, gts,
                    classes: int, model_kwargs: dict, chunk: int = 32,
                    device="cuda"):
    """mAP@0.5 of ``params`` (a state dict) under the full serving
    pipeline: a bf16 ``Detector`` at ``max_candidates=128`` in chunks of
    ``chunk``; also returns the detection count."""
    from torchfcn.serve.detector import Detector
    from torchfcn.train.validate import score_detection
    det = Detector(model_name, dtype=torch.bfloat16, max_candidates=128,
                   model_kwargs=dict(model_kwargs), device=device)
    det.model.load_state_dict(params)
    return score_detection(det, images, gts, classes, chunk=chunk)


def _summary(per_seed: Dict[str, list], key: str) -> Dict[str, dict]:
    return {tag: {key: round(float(np.mean(vals)), 4), "min": min(vals),
                  "max": max(vals), "per_seed": vals}
            for tag, vals in per_seed.items()}


def detection_gate(model_name: str, *,
                   serving_kwargs: Optional[dict] = None,
                   classes: int = 4, im: int = 448, stride: int = 16,
                   steps: int = 2500, batch: int = 16, n_cached: int = 30,
                   seeds: Sequence[int] = (0,), eval_images: int = 128,
                   root: str = DEFAULT_ROOT, with_seg: bool = False,
                   lr: float = 3e-4, warmup: int = 0,
                   weights: Optional[str] = None, log=None,
                   data_mode: str = "host_cached",
                   device="cuda") -> Dict[str, object]:
    """Train and score one detection family on the hard benchmark.

    Trains the exact model per seed and scores the same parameters exact
    and, with ``serving_kwargs``, through the e5m2 serving preset: e5m2
    storage is serving-only, so serving accuracy is measured on parameters
    trained exact, as deployed.  ``data_mode``: ``_train_hard``'s, and
    ``held_out_set``'s.  Returns {"exact": {"mAP", "min", "max",
    "per_seed"}, optional "fp8": {...}, "n_gt", "n_det", "eval_images",
    "seeds", "train_s", "eval_s"}."""
    from torchfcn.models import get_spec

    spec = get_spec(model_name)
    model_classes = classes + (1 if spec.background_channel is not None
                               else 0)
    grid = GridConfig(im, im, stride=stride, num_classes=model_classes)
    model_kwargs = {"num_classes": model_classes}
    images, gts, _ = held_out_set(root, grid, classes, eval_images,
                                  data_mode, device)
    n_gt = int(sum(len(g[1]) for g in gts))
    per_seed: Dict[str, list] = {"exact": []}
    if serving_kwargs:
        per_seed["fp8"] = []
    n_det = 0
    train_s = eval_s = 0.0
    for seed in seeds:
        t0 = time.time()
        state = _train_hard(model_name, grid, root, classes=classes,
                            steps=steps, batch=batch, n_cached=n_cached,
                            seed=seed, with_seg=with_seg,
                            model_kwargs=model_kwargs, lr=lr, warmup=warmup,
                            weights=weights, data_mode=data_mode, log=log,
                            device=device)
        train_s += time.time() - t0
        if log:
            log(f"{model_name} seed {seed}: {steps} steps in "
                f"{time.time() - t0:.1f} s")
        t0 = time.time()
        params = state.model.state_dict()
        m, nd = _score_detector(model_name, params, grid, images, gts,
                                classes, model_kwargs, device=device)
        per_seed["exact"].append(round(m, 4))
        n_det = max(n_det, nd)
        if serving_kwargs:
            m8, _ = _score_detector(model_name, params, grid, images, gts,
                                    classes, {**model_kwargs,
                                              **serving_kwargs},
                                    device=device)
            per_seed["fp8"].append(round(m8, 4))
        eval_s += time.time() - t0
    out: Dict[str, object] = {"n_gt": n_gt, "n_det": n_det,
                              "eval_images": int(images.shape[0]),
                              "seeds": list(seeds),
                              "train_s": round(train_s, 1),
                              "eval_s": round(eval_s, 1)}
    out.update(_summary(per_seed, "mAP"))
    return out


def _score_segmenter(model_name: str, params, images, segs, classes: int,
                     chunk: int = 32, device="cuda") -> float:
    """Held-out mean-IoU of ``params`` through a bf16 ``Segmenter``
    (demean -> forward -> argmax) with ``classes`` channels."""
    from torchfcn.serve.detector import serving_model
    from torchfcn.serve.segment import Segmenter
    from torchfcn.train.evaluate import evaluate_segmentation
    model = serving_model(model_name, torch.bfloat16, 0,
                          {"num_classes": classes}, device)
    model.load_state_dict(params)
    seg = Segmenter(model_name, model=model)
    preds = [seg(images[i:i + chunk]).cpu().numpy()
             for i in range(0, images.shape[0], chunk)]
    res = evaluate_segmentation(list(segs), list(np.concatenate(preds)),
                                num_classes=classes)
    return float(res["mean_iou"])


def segmentation_gate(model_name: str = "fcn32s_seg", *,
                      serving_name: str = "fcn32s_seg_serving",
                      classes: int = 4, im: int = 224, stride: int = 16,
                      steps: int = 2500, batch: int = 16,
                      n_cached: int = 30, seeds: Sequence[int] = (0,),
                      eval_images: int = 64, root: str = DEFAULT_ROOT,
                      warmup: int = 0, weights: Optional[str] = None,
                      log=None, data_mode: str = "host_cached",
                      device="cuda") -> Dict[str, object]:
    """FCN-32s family gate: held-out mean-IoU on the hard benchmark, the
    exact net and its e5m2 preset on the same parameters (masks carry
    label + 1; class 0 is background); ``data_mode`` as in
    ``detection_gate``."""
    C = classes + 1
    grid = GridConfig(im, im, stride=stride, num_classes=C)
    images, _, segs = held_out_set(root, grid, classes, eval_images,
                                   data_mode, device)
    per_seed: Dict[str, list] = {"exact": [], "fp8": []}
    train_s = eval_s = 0.0
    for seed in seeds:
        t0 = time.time()
        state = _train_hard(model_name, grid, root, classes=classes,
                            steps=steps, batch=batch, n_cached=n_cached,
                            seed=seed, with_seg=True,
                            model_kwargs={"num_classes": C}, warmup=warmup,
                            weights=weights, data_mode=data_mode, log=log,
                            device=device)
        train_s += time.time() - t0
        if log:
            log(f"{model_name} seed {seed}: {steps} steps in "
                f"{time.time() - t0:.1f} s")
        t0 = time.time()
        params = state.model.state_dict()
        for tag, name in (("exact", model_name), ("fp8", serving_name)):
            per_seed[tag].append(round(_score_segmenter(
                name, params, images, segs, C, device=device), 4))
        eval_s += time.time() - t0
    out: Dict[str, object] = {"eval_images": int(images.shape[0]),
                              "seeds": list(seeds),
                              "train_s": round(train_s, 1),
                              "eval_s": round(eval_s, 1)}
    out.update(_summary(per_seed, "mIoU"))
    return out


def voc_trainer(work_root: str, *, steps: int, batch: int, lr: float,
                seed: int, device="cuda"):
    """The VOC gate's Trainer: ``vgg_detectnet_train`` at 224x224 under the
    default policy (float32 parameters, bf16 convolutions), Adam at ``lr``
    times 0.3 from ``steps // 2`` on, the initial parameters seeded by
    ``seed``."""
    from torchfcn.models import build
    from torchfcn.train.trainer import Trainer
    cfg = TrainConfig(grid=VOC_GRID, model="vgg_detectnet_train",
                      data=DataConfig(batch_size=batch),
                      optimizer="adam", learning_rate=lr,
                      lr_decay_step=max(steps // 2, 1), lr_gamma=0.3,
                      max_iter=steps, snapshot_every=0,
                      snapshot_dir=os.path.join(work_root, "snap"),
                      log_every=10 ** 9, seed=seed)
    return Trainer(cfg, model=build("vgg_detectnet_train"),
                   log_sink=lambda s: None, device=device)


def score_voc(trainer, state, images, gts) -> Dict[str, object]:
    """{"mAP", "n_det"} of ``state``'s model on a held-out set through
    ``detection_validator`` (chunks of 8), called as the Trainer calls its
    validator: eval mode, no gradients, the policy's precision."""
    from torchfcn.train.validate import detection_validator
    validate = detection_validator("vgg_detectnet_train", images, gts,
                                   chunk=min(8, len(images)))
    state.model.eval()
    try:
        with torch.no_grad(), trainer.policy.precision():
            return validate(state.model)
    finally:
        state.model.train()


def voc_fixture_gate(fixture_root: Optional[str] = None, *,
                     steps: int = 3000, batch: int = 16,
                     n_cached: int = 10, lr: float = 1e-4, seed: int = 0,
                     work_root: str = VOC_WORK_ROOT,
                     device="cuda") -> Dict[str, object]:
    """Tracked mAP on the committed VOC fixture (``tests/fixtures/voc_mini``,
    an image source independent of the training compositor), through the
    reference's own data flow: the VOC converter writes the manifests,
    ``create_detection_records`` the record shards, ``RecordTrainPipeline``
    feeds a ``DeviceBatchCache`` of ``n_cached`` batches, and
    ``vgg_detectnet_train`` trains at 224x224 for ``steps`` steps; then the
    val split is scored at 448x448 under the full serving pipeline.
    Returns tpufcn's keys: mAP, n_det, val_images, n_gt and the seconds of
    each stage (convert_s, compose_s, train_s, eval_s)."""
    from torchfcn.data.manifest import read_voc_manifest
    from torchfcn.data.pipeline import DeviceBatchCache, RecordTrainPipeline
    from torchfcn.data.records import create_detection_records
    from torchfcn.data.voc import PascalVOC
    from torchfcn.train.validate import val_set_from_voc

    fixture_root = fixture_root or VOC_FIXTURE_ROOT
    t0 = time.time()
    man = os.path.join(work_root, "man")
    PascalVOC(fixture_root, classes=FIXTURE_CLASSES).create(man)
    rec = os.path.join(work_root, "rec", "ds")
    create_detection_records(
        read_voc_manifest(os.path.join(man, "train.txt")), rec)
    convert_s = time.time() - t0

    trainer = voc_trainer(work_root, steps=steps, batch=batch, lr=lr,
                          seed=seed, device=device)
    t0 = time.time()
    pipe = RecordTrainPipeline(rec, VOC_GRID, batch_size=batch,
                               seed=1000 + seed)
    cache = DeviceBatchCache(trainer.put, iter(pipe), n_batches=n_cached)
    compose_s = time.time() - t0
    t0 = time.time()
    state = trainer.fit(iter(cache), max_iter=steps, resume=False)
    train_s = time.time() - t0

    # scored at 448x448 (trained at 224x224): the net is fully
    # convolutional, and at twice the size the objects clear the NMS
    # height floor with more grid evidence each
    t0 = time.time()
    vi, vg = val_set_from_voc(os.path.join(man, "val.txt"), VOC_EVAL_HW)
    res = score_voc(trainer, state, vi, vg)
    res["val_images"] = int(vi.shape[0])
    res["n_gt"] = int(sum(len(g[1]) for g in vg))
    res.update(convert_s=round(convert_s, 1), compose_s=round(compose_s, 1),
               train_s=round(train_s, 1), eval_s=round(time.time() - t0, 1))
    return res


# the voc_fixture gate's wall in both tiers, a single unit whose inputs are
# converted in every run (never cold): 53.2 and 79.4 s in two runs of
# chip_smoke.py's records phase on an NVIDIA H100 80GB HBM3 at 700 W (its
# steps wait on the host), the larger rounded up
VOC_EST_S = 80


def bench_gate_configs(tier: str = "bench") -> Dict[str, dict]:
    """The tracked per-family gate configurations, the JAX package's two
    tiers: ``"bench"``,
    the capture tier (batch 32 for segmentation, 16 for detection, short
    horizons, small held-out sets; config order = run order, cheapest
    first), and ``"full"``, the deep-calibration tier (batch 16, 6k
    steps).  The fp8 serving kwargs are each family's ``_serving``
    preset's (``torchfcn.models.registry``).

    ``est_s`` is a unit's wall (train and both scorings, warm caches), in
    seconds on one NVIDIA H100 80GB HBM3 at 700 W: the capture tier's as
    measured by ``python -m torchfcn.cli gates``, the full tier's derived
    from them.  ``est_s0``, a unit's first-touch wall, is derived for the
    host-cached default, not measured: the unit's host scenes (``n_cached
    * batch`` cached training scenes and ``eval_images`` held-out ones)
    times the host's ms per scene at the gate's geometry that phase 15 of
    ``chip_smoke.py`` measured on that card's host (70.0 at 448x448, 46.6
    at 288x288, 44.7 at 224x224), plus ``est_s``, rounded up (the
    pretrain's and the VOC gate's compose no scene and keep their measured
    walls).  Phase 15 measured googlenet_3cls's first touch at 144.9 s
    (62.7 + 6.5 s composing, a 75.7 s unit) against the 147 derived."""
    e5m2 = torch.float8_e5m2
    gnet_fp8 = {"store_dtype": e5m2, "store_blocks": True,
                "store_stem2": True}
    if tier == "full":
        # not run on the card: steps over the capture tier's measured
        # steps per second of the same family (NVIDIA H100 80GB HBM3,
        # 700 W), rounded up
        return {
            "fcn32s": dict(
                kind="segmentation", steps=2500, n_cached=60,
                seeds=(0, 1), est_s=60, est_s0=106),
            "googlenet_3cls": dict(
                kind="detection", model="googlenet_detectnet_3cls",
                classes=3, im=448, stride=16, steps=6000, n_cached=60,
                seeds=(0, 1), lr=2e-4, eval_images=192, est_s=220,
                est_s0=301, serving_kwargs=dict(gnet_fp8)),
            "voc_fixture": dict(kind="voc", est_s=VOC_EST_S,
                                est_s0=VOC_EST_S),
            "googlenet": dict(
                kind="detection", model="googlenet_detectnet",
                classes=4, im=448, stride=16, steps=6000, n_cached=60,
                seeds=(0, 1), est_s=210, est_s0=287,
                serving_kwargs=dict(gnet_fp8)),
            "fcn8s": dict(
                kind="detection", model="fcn8s_bbox",
                classes=4, im=288, stride=8, steps=6000, n_cached=90,
                seeds=(0, 1, 2), with_seg=True, est_s=150, est_s0=221,
                serving_kwargs={"store_dtype": e5m2, "store_stages": 2}),
            "vgg_pyramid": dict(
                kind="detection", model="vgg_pyramid_detectnet",
                classes=4, im=448, stride=16, steps=6000, n_cached=60,
                seeds=(0, 1), lr=1e-4, est_s=225, est_s0=302,
                serving_kwargs={"store_dtype": e5m2}),
        }
    # capture tier: est_s the walls of each unit of a run of every family
    # through `python -m torchfcn.cli gates` on an NVIDIA H100 80GB HBM3 at
    # 700 W (PERF.md, section 6), rounded up; est_s0 derived as above
    return {
        "fcn32s": dict(
            kind="segmentation", steps=1250, batch=32, n_cached=30,
            seeds=(0, 1), est_s=30, est_s0=76),
        "voc_fixture": dict(kind="voc", est_s=VOC_EST_S, est_s0=VOC_EST_S),
        "fcn8s": dict(
            kind="detection", model="fcn8s_bbox",
            classes=4, im=288, stride=8, steps=2500, n_cached=90,
            seeds=(0, 1, 2), with_seg=True, eval_images=64,
            est_s=61, est_s0=132,
            serving_kwargs={"store_dtype": e5m2, "store_stages": 2}),
        # the shared VGG16 backbone pretrain; only vgg_pyramid fine-tunes
        # from it (the JAX package's capture-tier choice).  Warm: the
        # cached file
        "vgg16_pretrain": dict(
            kind="pretrain", classes=6, steps=4000, size=128,
            n_bank=8192, lr=1e-4, seed=0, est_s=1, est_s0=83),
        "vgg_pyramid": dict(
            kind="detection", model="vgg_pyramid_detectnet",
            classes=4, im=448, stride=16, steps=2000, n_cached=60,
            seeds=(0, 1), lr=1e-4, eval_images=64, pretrain=True,
            est_s=75, est_s0=147,
            serving_kwargs={"store_dtype": e5m2}),
        "googlenet_3cls": dict(
            kind="detection", model="googlenet_detectnet_3cls",
            classes=3, im=448, stride=16, steps=2000, n_cached=60,
            seeds=(0, 1), lr=1e-4, eval_images=96, est_s=73,
            est_s0=147, serving_kwargs=dict(gnet_fp8)),
        "googlenet": dict(
            kind="detection", model="googlenet_detectnet",
            classes=4, im=448, stride=16, steps=2000, n_cached=60,
            seeds=(0, 1), eval_images=128, est_s=69, est_s0=146,
            serving_kwargs=dict(gnet_fp8)),
    }


# Later-pass seed order: leftover budget goes to extra seeds of the
# families with the largest known seed spread first (the JAX package's
# order)
SEED_APPEND_PRIORITY = ("fcn8s", "googlenet_3cls", "vgg_pyramid",
                        "googlenet", "fcn32s")


def _seed_rank(name: str) -> int:
    try:
        return SEED_APPEND_PRIORITY.index(name)
    except ValueError:
        return len(SEED_APPEND_PRIORITY)


def plan_gate_units(cfgs: Dict[str, dict]):
    """Breadth-first per-seed schedule ``[(family, seed_index), ...]``:
    pass 0 runs seed[0] of every family in config order; each later pass
    appends one more seed per multi-seed family, in
    ``SEED_APPEND_PRIORITY`` order."""
    units = [(name, 0) for name in cfgs]
    n_extra = max((len(c.get("seeds", (0,))) for c in cfgs.values()),
                  default=1) - 1
    for p in range(1, n_extra + 1):
        for name in sorted(cfgs, key=_seed_rank):
            if len(cfgs[name].get("seeds", (0,))) > p:
                units.append((name, p))
    return units


def _gate_defaults(fn) -> Dict[str, object]:
    import inspect
    return {k: v.default for k, v in inspect.signature(fn).parameters.items()
            if v.default is not inspect.Parameter.empty}


def _gate_geometry(kind: str, cfg: dict):
    """(the gate's arguments with its defaults, its grid) of a
    segmentation or detection entry."""
    if kind == "segmentation":
        g = {**_gate_defaults(segmentation_gate), **cfg}
        model_classes = g["classes"] + 1
    else:
        from torchfcn.models import get_spec
        g = {**_gate_defaults(detection_gate), **cfg}
        model_classes = g["classes"] + (
            1 if get_spec(cfg["model"]).background_channel is not None
            else 0)
    return g, GridConfig(g["im"], g["im"], stride=g["stride"],
                         num_classes=model_classes)


def _unit_cold(kind: str, cfg: dict, root: str, seed: int) -> bool:
    """Whether a gate unit pays first-touch costs: its cached training
    scenes (seed ``1000 + seed``) or its held-out set are not on disk
    (pretrain: its ``.caffemodel``), so the scheduler budgets ``est_s0``
    instead of ``est_s``.  The VOC gate converts its small inputs in every
    run (its first-touch costs live in ``est_s``)."""
    if kind == "pretrain":
        from torchfcn.train.pretrain import pretrain_cache_path
        return not os.path.isfile(pretrain_cache_path(root, **cfg))
    if kind not in ("segmentation", "detection"):
        return False
    g, grid = _gate_geometry(kind, cfg)
    train = train_cache_path(root, grid, classes=g["classes"],
                             batch=g["batch"], n_cached=g["n_cached"],
                             seed=1000 + seed)
    return not (os.path.isfile(train) and os.path.isfile(
        eval_cache_path(root, grid, g["classes"], g["eval_images"])))


def _merge_family(old: Optional[dict], new: dict) -> dict:
    """Fold one seed unit's result into the family's accumulated result
    (mean/min/max recomputed over the concatenated per-seed lists)."""
    if (not isinstance(old, dict) or "error" in old or "skipped" in old
            or not any(isinstance(old.get(t), dict) and "per_seed" in old[t]
                       for t in ("exact", "fp8"))):
        return new
    if "error" in new:
        out = dict(old)
        out["error_later_seed"] = new["error"]
        return out
    out = dict(new)
    out["seeds"] = list(old.get("seeds", [])) + list(new.get("seeds", []))
    for tag in ("exact", "fp8"):
        if isinstance(old.get(tag), dict) and isinstance(new.get(tag), dict):
            vals = list(old[tag]["per_seed"]) + list(new[tag]["per_seed"])
            key = "mIoU" if "mIoU" in new[tag] else "mAP"
            out[tag] = {key: round(float(np.mean(vals)), 4),
                        "min": min(vals), "max": max(vals),
                        "per_seed": vals}
    if "n_det" in old or "n_det" in new:
        out["n_det"] = max(old.get("n_det", 0), new.get("n_det", 0))
    for k in ("train_s", "eval_s", "wall_s"):
        if k in old or k in new:
            out[k] = round(old.get(k, 0.0) + new.get(k, 0.0), 1)
    return out


def warm_gate_caches(root: str = DEFAULT_ROOT,
                     only: Optional[Sequence[str]] = None, log=print,
                     tier: str = "bench", device="cuda") -> Dict[str, str]:
    """Compose every tracked gate's on-disk inputs without training: each
    family's held-out set and each seed's cached training scenes, and the
    pretrain (which does train, on ``device``); the VOC gate has none (it
    converts its own small inputs in every run).  Returns {cache path:
    "composed" | "warm"}."""
    out: Dict[str, str] = {}

    def _touch(path, compose):
        if os.path.isfile(path):
            out[path] = "warm"
        else:
            compose()
            out[path] = "composed"
        log(f"{out[path]}: {os.path.basename(path)}")

    for name, cfg in bench_gate_configs(tier).items():
        if only is not None and name not in only:
            continue
        kind = cfg["kind"]
        if kind == "pretrain":
            from torchfcn.train.pretrain import (
                cached_vgg16_pretrain, pretrain_cache_path)
            c = {k: v for k, v in cfg.items()
                 if k not in ("kind", "est_s", "est_s0")}
            _touch(pretrain_cache_path(root, **c),
                   lambda: cached_vgg16_pretrain(root, log=log, device=device,
                                                 **c))
            continue
        if kind not in ("segmentation", "detection"):
            continue
        g, grid = _gate_geometry(kind, cfg)
        _touch(eval_cache_path(root, grid, g["classes"], g["eval_images"]),
               lambda: build_eval_set(root, grid, classes=g["classes"],
                                      n_images=g["eval_images"]))
        for seed in g.get("seeds", (0,)):
            path = train_cache_path(root, grid, classes=g["classes"],
                                    batch=g["batch"],
                                    n_cached=g["n_cached"],
                                    seed=1000 + seed)
            _touch(path, lambda s=seed: _cached_host_batches(
                root, grid, classes=g["classes"], batch=g["batch"],
                n_cached=g["n_cached"], seed=1000 + s, log=log))
    return out


def run_bench_gates(root: str = DEFAULT_ROOT,
                    only: Optional[Sequence[str]] = None, log=print,
                    deadline: Optional[float] = None, sink=None,
                    passes: Optional[Sequence[int]] = None,
                    prior: Optional[Dict[str, dict]] = None,
                    tier: str = "bench", device="cuda") -> Dict[str, dict]:
    """Run the tracked gates as budgeted per-seed units -> {family: gate
    result}.

    Units come from ``plan_gate_units``.  Before each unit its estimate
    (``est_s``, or ``est_s0`` when ``_unit_cold``), scaled by the median
    ratio of the walls to the estimates so far (at least 0.6), is held
    against ``deadline``: a unit that does not fit is skipped
    ({"skipped": "budget"} for a family with no result yet, else
    ``seeds_skipped``) and the family's later units with it.  A unit's
    failure is reported as {"error": ...} and ends its family.
    ``sink(partial)`` is called after every unit.  ``passes``: run only the
    units of those seed indices; ``prior``: results of an earlier call to
    merge into.  A ``pretrain`` entry trains the VGG16 backbone; entries
    with ``pretrain=True`` fine-tune from it (from scratch, reporting
    ``"pretrained": false``, if it was skipped or failed)."""
    import traceback
    cfgs = bench_gate_configs(tier)
    if only is not None:
        cfgs = {k: v for k, v in cfgs.items() if k in only}
    out: Dict[str, dict] = dict(prior) if prior else {}
    done = {n for n, r in out.items()
            if isinstance(r, dict) and ({"skipped", "error",
                                         "seeds_skipped"} & r.keys())}
    pretrain_path: Optional[str] = None
    for n, r in out.items():
        if (cfgs.get(n, {}).get("kind") == "pretrain"
                and isinstance(r, dict) and r.get("path")):
            pretrain_path = r["path"]
    ratios: list = []

    def _factor():
        return max(0.6, float(np.median(ratios))) if ratios else 1.0

    for name, si in plan_gate_units(cfgs):
        if name in done or (passes is not None and si not in passes):
            continue
        cfg = dict(cfgs[name])
        kind = cfg.pop("kind")
        est_s = cfg.pop("est_s", 0)
        est_s0 = cfg.pop("est_s0", est_s)
        seeds = tuple(cfg.pop("seeds", (0,)))
        base_est = (est_s0 if _unit_cold(kind, cfg, root, seeds[si])
                    else est_s)
        unit_est = base_est * _factor()
        if deadline is not None and time.time() + unit_est > deadline:
            left = max(deadline - time.time(), 0)
            if name in out:
                out[name]["seeds_skipped"] = (
                    out[name].get("seeds_skipped", 0) + len(seeds) - si)
                log(f"gate[{name}]: seeds {list(seeds[si:])} skipped: est "
                    f"{unit_est:.0f}s/unit exceeds the remaining budget "
                    f"({left:.0f}s)")
            else:
                out[name] = {"skipped": "budget",
                             "est_s": round(unit_est, 1)}
                log(f"gate[{name}]: skipped: est {unit_est:.0f}s exceeds "
                    f"the remaining budget ({left:.0f}s)")
            done.add(name)
            continue
        t0 = time.time()
        try:
            if kind == "pretrain":
                from torchfcn.train import pretrain
                pretrain_path = pretrain.cached_vgg16_pretrain(
                    root, log=log, device=device, **cfg)
                res = {"path": pretrain_path}
            elif kind == "segmentation":
                res = segmentation_gate(root=root, seeds=(seeds[si],),
                                        log=log, device=device, **cfg)
            elif kind == "voc":
                res = voc_fixture_gate(device=device, **cfg)
            elif kind == "detection":
                model = cfg.pop("model")
                fine_tune = cfg.pop("pretrain", False)
                if fine_tune:
                    cfg["weights"] = pretrain_path
                res = detection_gate(model, root=root, seeds=(seeds[si],),
                                     log=log, device=device, **cfg)
                if fine_tune:
                    res["pretrained"] = pretrain_path is not None
            else:
                raise NotImplementedError(f"gate kind {kind!r} is not ported")
        except Exception as e:   # noqa: BLE001 - report, don't abort
            log(traceback.format_exc())
            res = {"error": f"{type(e).__name__}: {e}"}
            done.add(name)
        res["wall_s"] = round(time.time() - t0, 1)
        if base_est > 0:
            ratios.append((time.time() - t0) / base_est)
        if kind in ("pretrain", "voc"):
            done.add(name)       # single-unit kinds
        out[name] = _merge_family(out.get(name), res)
        log(f"gate[{name}] unit seed[{si}]: {res}")
        if sink is not None:
            try:
                sink(dict(out))
            except Exception as e:   # noqa: BLE001 - the sink is best-effort
                log(f"gate sink failed: {e}")
    return out
