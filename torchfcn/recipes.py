"""Training recipes of the port: the reference solver configurations as
presets, copies of ``tpufcn/recipes.py`` (importing that module would run
``tpufcn/core/__init__.py`` and with it JAX).

Each mirrors one reference solver + train prototxt pair (SURVEY.md C21):

* ``bounding_box`` — ADAM lr 1e-4, step 0.1 @ 10k, wd 1e-7, snapshot 5k;
  VGG DetectNet head, 224x224 stride 8, batch 32, 11 classes
  (reference train/bounding_box/solver.prototxt:3-16, train_val.prototxt:14).
* ``fcn_bbox`` — SGD momentum 0.9, fixed lr 1e-10, wd 1e-7, snapshot 10k;
  FCN-8s+bbox, 288x288 stride 8, batch 24, 11 classes
  (reference train/fcn_bbox/solver.prototxt:1-13, train_val.prototxt:13).
* ``semantic_segmentation`` — SGD momentum 0.9, fixed lr 1e-10; FCN-32s,
  224x224, batch 30, 12 classes
  (reference train/semantic_segmentation/solver.prototxt:1-13).
* ``voc`` — the VOC multiclass config: 448x448 stride 16, batch 10,
  20 classes on the pyramid deploy head
  (reference train/bounding_box/train_val.prototxt:31).
"""

from __future__ import annotations

import dataclasses

from torchfcn.core.config import DataConfig, GridConfig, TrainConfig


def bounding_box(**overrides) -> TrainConfig:
    cfg = TrainConfig(
        grid=GridConfig(224, 224, stride=8, num_classes=11),
        data=DataConfig(batch_size=32),
        model="vgg_detectnet_train",
        optimizer="adam", learning_rate=1e-4,
        lr_decay_step=10000, lr_gamma=0.1,
        weight_decay=1e-7, snapshot_every=5000)
    return dataclasses.replace(cfg, **overrides)


def fcn_bbox(**overrides) -> TrainConfig:
    cfg = TrainConfig(
        grid=GridConfig(288, 288, stride=8, num_classes=11),
        data=DataConfig(batch_size=24),
        model="fcn8s_bbox",
        optimizer="sgd", learning_rate=1e-10, lr_decay_step=0,
        momentum=0.9, weight_decay=1e-7, snapshot_every=10000,
        # the reference fcn_bbox loss graph is L1(bbox) x2 + softmax seg
        # only — no coverage EuclideanLoss (train/fcn_bbox/train_val.prototxt)
        coverage_loss_weight=0.0)
    return dataclasses.replace(cfg, **overrides)


def semantic_segmentation(**overrides) -> TrainConfig:
    cfg = TrainConfig(
        grid=GridConfig(224, 224, stride=16, num_classes=12),
        data=DataConfig(batch_size=30),
        model="fcn32s_seg",
        optimizer="sgd", learning_rate=1e-10, lr_decay_step=0,
        momentum=0.9, weight_decay=1e-7, snapshot_every=10000)
    return dataclasses.replace(cfg, **overrides)


def voc(**overrides) -> TrainConfig:
    cfg = TrainConfig(
        grid=GridConfig(448, 448, stride=16, num_classes=20),
        data=DataConfig(batch_size=10, add_background_class=False),
        model="vgg_pyramid_detectnet",
        optimizer="adam", learning_rate=1e-4,
        lr_decay_step=10000, lr_gamma=0.1,
        weight_decay=1e-7, snapshot_every=5000)
    return dataclasses.replace(cfg, **overrides)


RECIPES = {
    "bounding_box": bounding_box,
    "fcn_bbox": fcn_bbox,
    "semantic_segmentation": semantic_segmentation,
    "voc": voc,
}


def get(name: str, **overrides) -> TrainConfig:
    if name not in RECIPES:
        raise KeyError(f"unknown recipe '{name}'; have {sorted(RECIPES)}")
    return RECIPES[name](**overrides)
