"""Backbone pretraining of the port (``tpufcn/train/pretrain.py``): the
reference's fine-tune-from-pretrained workflow without a download.

The reference seeds VGG16 from the ILSVRC ``.caffemodel``; with no network
the JAX package trains the VGG16 conv stack as a classifier of hard-
benchmark crops (``torchfcn.data.hardbench``) and exports it as a
``.caffemodel`` named by the VGG16 conv layers, which the gates and
``resolve_weights`` load leniently by name.

The crop bank is rendered once on the host (uint8), moved to the device
once, and every step draws its minibatch and flips there, from a
``torch.Generator`` on the device.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torchfcn.data.hardbench import (
    CLASS_DEFS, _color_field, _paste, distractor_defs, render_object)
from torchfcn.models.layers import CaffeConv, ZooModel, nchw
from torchfcn.models.vgg import VGG16Backbone

# the pretrain logs its loss and accuracy at step 1, every LOG_EVERY steps
# and at its last step; each log line reads the loss back to the host
LOG_EVERY = 100


def render_cls_dataset(classes: int = 4, n: int = 4096, size: int = 96,
                       seed: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """Classification crop bank: (images (N, size, size, 3) uint8, labels
    int32).  Labels ``0..classes-1`` are the shape x texture classes,
    ``classes`` any mismatched (distractor) pairing and ``classes + 1``
    pure clutter, so that only the conjunction separates class from
    distractor."""
    rng = np.random.default_rng(seed)
    defs = distractor_defs(classes)
    images = np.empty((n, size, size, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    for i in range(n):
        lab = int(rng.integers(0, classes + 2))
        img = _color_field(size, size, rng)
        if lab < classes + 1:
            shape, texture = (CLASS_DEFS[lab] if lab < classes
                              else defs[int(rng.integers(0, len(defs)))])
            # a wide scale range, so that features transfer across the
            # detection benchmark's object scales
            h = int(rng.integers(24, size - 4))
            w = int(rng.integers(24, size - 4))
            x = int(rng.integers(0, size - w))
            y = int(rng.integers(0, size - h))
            _paste(img, *render_object(shape, texture, h, w, rng), x, y)
        images[i] = img
        labels[i] = lab
    return images, labels


class VGG16Classifier(ZooModel):
    """The VGG16 conv stack, a float32 global average pool of conv5_3 and a
    1x1 conv head ``fc_cls`` (kept 4-D so that it exports; lenient seeding
    drops it).  Input: demeaned NHWC; output (B, classes) float32 logits.
    Parameter names follow the JAX package's tree (``backbone/conv1_1``,
    ``fc_cls``), so ``convert.from_jax`` carries its parameters across and
    ``export_caffemodel`` writes its layer names."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.backbone = VGG16Backbone()
        self.fc_cls = CaffeConv(512, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.backbone(nchw(x))["conv5_3"]
        y = y.float().mean(dim=(-2, -1), keepdim=True)
        return self.fc_cls(y.to(self.fc_cls.dtype))[:, :, 0, 0].float()


def pretrain_vgg16(out_path: str, *, classes: int = 4, steps: int = 1500,
                   batch: int = 128, size: int = 96, n_bank: int = 4096,
                   lr: float = 3e-4, seed: int = 0, log=None,
                   device="cuda") -> Dict[str, float]:
    """Train the VGG16 conv stack as a crop classifier and export it to
    ``out_path`` (``.caffemodel``).  Adam at ``lr`` times 0.3 from step
    ``steps // 2`` on, minibatches of ``batch`` drawn with replacement
    from the bank, each image flipped left-right with p = 0.5, demeaned;
    float32 parameters, bf16 convolutions (``DTypePolicy()``).  Logs at
    step 1, every ``LOG_EVERY`` steps and at the last step.  Returns
    {"loss", "train_acc", "steps", "path", "loss_start"}: the last step's
    loss and accuracy, and the first step's loss.  Deterministic for fixed
    arguments on one device."""
    from torchfcn.convert import export_caffemodel
    from torchfcn.core.device import port_device
    from torchfcn.core.dtypes import DTypePolicy
    from torchfcn.ops.image import demean_bgr

    device = port_device(device, "pretrain_vgg16")
    log = log or (lambda s: None)
    images, labels = render_cls_dataset(classes=classes, n=n_bank,
                                        size=size, seed=7)
    log(f"pretrain: bank {images.shape} rendered")
    bank_x = torch.from_numpy(images).to(device)
    bank_y = torch.from_numpy(labels).long().to(device)

    model = VGG16Classifier(classes + 2)
    model.init_weights(torch.Generator().manual_seed(seed))
    policy = DTypePolicy()
    policy.apply(model)
    model = model.to(device=device, memory_format=torch.channels_last)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    decay_at = max(steps // 2, 1)
    gen = torch.Generator(device=device).manual_seed(1000 + seed)
    loss = acc = loss_start = float("nan")
    for step in range(steps):
        for group in opt.param_groups:
            group["lr"] = lr * 0.3 ** (step // decay_at)
        idx = torch.randint(0, bank_x.shape[0], (batch,), generator=gen,
                            device=device)
        flip = torch.rand((batch,), generator=gen, device=device) < 0.5
        x = bank_x[idx]
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        with policy.precision():
            logits = model(demean_bgr(x))
        y = bank_y[idx]
        ce = F.cross_entropy(logits, y)
        opt.zero_grad(set_to_none=True)
        ce.backward()
        opt.step()
        if step == 0 or (step + 1) % LOG_EVERY == 0 or step + 1 == steps:
            loss = float(ce.detach())
            acc = float((logits.argmax(-1) == y).float().mean())
            if step == 0:
                loss_start = loss
            log(f"pretrain: step {step + 1}/{steps} loss {loss:.4f} "
                f"acc {acc:.3f}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    export_caffemodel(model, out_path)
    return {"loss": round(loss, 4), "train_acc": round(acc, 4),
            "steps": steps, "path": out_path,
            "loss_start": round(loss_start, 4)}


def cached_vgg16_pretrain(root: str, *, classes: int = 4, steps: int = 1500,
                          seed: int = 0, size: int = 96, n_bank: int = 4096,
                          lr: float = 3e-4, log=None, device="cuda") -> str:
    """Pretrain once per ``root`` and configuration and reuse the exported
    ``.caffemodel`` (the gates share one backbone across the VGG families,
    as the reference shares one ILSVRC VGG16).  The cache tag carries
    every knob, so a changed configuration never reuses a stale file."""
    path = pretrain_cache_path(root, classes=classes, steps=steps, seed=seed,
                               size=size, n_bank=n_bank, lr=lr)
    if os.path.isfile(path):
        return path
    os.makedirs(root, exist_ok=True)
    res = pretrain_vgg16(path, classes=classes, steps=steps, seed=seed,
                         size=size, n_bank=n_bank, lr=lr, log=log,
                         device=device)
    if log:
        log(f"pretrain: cached {path} ({res})")
    return path


def pretrain_cache_path(root: str, *, classes: int = 4, steps: int = 1500,
                        seed: int = 0, size: int = 96, n_bank: int = 4096,
                        lr: float = 3e-4) -> str:
    """Where ``cached_vgg16_pretrain`` keeps its ``.caffemodel`` (the gate
    scheduler probes it)."""
    return os.path.join(
        root, f"vgg16_hardbench_c{classes}_s{steps}_sz{size}_n{n_bank}"
              f"_lr{lr:g}_seed{seed}.caffemodel")
