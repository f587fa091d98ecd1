"""The train step of the port (``tpufcn/train/step.py``), eager PyTorch on
one device:

  batch {image, GT rects, labels, valid[, seg]} on the device
  -> preprocessing ("demean" for the VGG and FCN families; GoogLeNet and
     ResNet-FPN normalise raw frames themselves)
  -> forward in train mode (dropout from the state's generator)
  -> grid-label encoding on the device (``torchfcn.ops.grid_codec``)
  -> Caffe-semantics losses -> backward -> optimizer update

The model runs under the state's ``DTypePolicy``: float32 parameters and
optimizer state, convolutions in the compute dtype, and TF32 off under
``parity()``.  The LRN kernels' custom ops carry the backward through the
GoogLeNet stem.

On a (data, space) mesh (``torchfcn.core.mesh``, one process per rank;
``tpufcn/train/step.py:82-88,182-228``) each rank holds a replica of the
model and its share of the batch: its batch shard and, with ``space > 1``,
its band of the image and seg rows (``core.mesh.row_bands``) and the grid
labels of the same band.  Every loss term is a sum over cells or pixels
divided by the batch shard's size (Caffe's normalisations, the global
counts of a data shard whatever its bands), so the space ranks' losses add
up to their shard's loss; after the local backward the gradients are
summed over the mesh and divided by ``data``: the gradient of the global
batch's loss, once per update (after ``iter_size`` micro-batches).  The
metrics are reduced the same way (counts are summed).  Dropout draws the
global batch's mask on every rank (``models.layers.dropout``), so an N-rank
step equals the one-device step.  Unequal local batches are refused
(``core.mesh.local_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from torchfcn.core.config import TrainConfig
from torchfcn.core.device import port_device
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.core.mesh import Mesh, space_sharded
from torchfcn.ops.grid_codec import GridLabels, encode_grid_labels_batch
from torchfcn.ops.image import demean_bgr
from torchfcn.train.losses import detectnet_loss

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and its state, the count
    of updates so far and the dropout generator; the policy the model runs
    under."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    policy: DTypePolicy
    step: int = 0

    def state_dict(self) -> dict:
        """What a snapshot keeps: the step, the parameters (on the CPU),
        the optimizer state and the generator state."""
        return {"step": self.step,
                "params": {k: v.detach().cpu()
                           for k, v in self.model.state_dict().items()},
                "opt_state": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, snapshot: dict) -> None:
        self.step = int(snapshot["step"])
        self.model.load_state_dict(snapshot["params"])
        self.optimizer.load_state_dict(snapshot["opt_state"])
        self.generator.set_state(snapshot["generator"])


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate of update ``count`` (from 0): a linear warmup from
    0 over ``warmup_steps``, then ``learning_rate`` times ``lr_gamma`` once
    per ``lr_decay_step`` updates after the warmup (staircase; no decay at
    ``lr_decay_step`` 0), as the JAX package's optax schedule."""
    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return cfg.learning_rate * count / cfg.warmup_steps
        count -= cfg.warmup_steps
        if cfg.lr_decay_step > 0:
            return cfg.learning_rate * cfg.lr_gamma ** (
                count // cfg.lr_decay_step)
        return cfg.learning_rate
    return schedule


def make_optimizer(cfg: TrainConfig,
                   params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """Caffe solver semantics (reference train/*/solver.prototxt): Adam
    (betas 0.9, 0.999, eps 1e-8) or SGD with momentum, with the weight
    decay added to the gradients as L2 before the update, as
    ``optax.chain(add_decayed_weights, adam)`` does; ``torch.optim.Adam``'s
    ``weight_decay`` is that (``AdamW``'s is not).  The learning rate of
    each update comes from ``make_schedule`` (``apply_update``)."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate,
                               momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def apply_update(optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], count: int) -> None:
    """Update ``count`` (from 0) with the gradients in the parameters'
    ``.grad``, at the schedule's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = schedule(count)
    optimizer.step()


def make_loss_fn(cfg: TrainConfig, with_seg: bool = False,
                 preprocessing: str = "demean",
                 label_offset: int = 0,
                 mesh: Optional[Mesh] = None) -> Callable:
    """(model, batch, generator) -> (total loss, metrics).

    ``label_offset=1`` for background-channel families (fcn8s_bbox): the
    0-based object ids shift to 1..C-1 before grid encoding, so that object
    j's coverage and bbox supervision lands on channel j + 1, the channel
    the seg softmax supervises as class j + 1 (the reference's one-based
    manifest labels).  On a mesh the batch is this rank's share and the
    loss its part: the grid labels of its band of grid rows, and its band
    of the seg masks (``shard_batch`` sliced them)."""
    grid = cfg.grid
    kw = {} if mesh is None else {"mesh": mesh}

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: torch.Generator):
        img = batch["image"]
        img = demean_bgr(img, mesh) if preprocessing == "demean" \
            else img.to(torch.float32)
        out = model(img, generator=generator, **kw)
        labels = encode_grid_labels_batch(
            batch["rects"], batch["labels"] + label_offset, batch["valid"],
            grid)
        if space_sharded(mesh):
            # the frame's band of rows, in grid rows (offsets divide)
            offset, rows = mesh.band(grid.im_height)
            band = slice(offset // grid.stride,
                         -(-(offset + rows) // grid.stride))
            labels = GridLabels(*(t[:, band] for t in labels))
        if with_seg and "seg" not in batch:
            raise ValueError(
                "with_seg=True but the batch carries no 'seg' masks; train "
                "with with_seg=False (detection heads only) or give masks")
        return detectnet_loss(
            out, labels, bbox_weight=cfg.bbox_loss_weight,
            coverage_weight=cfg.coverage_loss_weight,
            seg_labels=batch.get("seg") if with_seg else None,
            seg_weight=cfg.seg_loss_weight)

    return loss_fn


def make_grads_fn(loss_fn: Callable, iter_size: int = 1) -> Callable:
    """(model, batch, generator) -> (grads, metrics), the gradients left in
    each parameter's ``.grad`` (and returned by name).

    ``iter_size > 1``: Caffe gradient accumulation.  Batch leaves carry a
    leading (iter_size, B, ...) micro-batch axis; each micro-batch's
    gradients add up in ``.grad`` and the sum is divided by ``iter_size``
    (Caffe's ``Solver::Normalize``).  Each micro-batch draws its own
    dropout from the generator; the metrics are the micro-batches' mean."""
    def grads_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator):
        model.zero_grad(set_to_none=True)
        if iter_size <= 1:
            loss, metrics = loss_fn(model, batch, generator)
            loss.backward()
        else:
            per_micro = []
            for i in range(iter_size):
                loss, m = loss_fn(model, {k: v[i] for k, v in batch.items()},
                                  generator)
                loss.backward()
                per_micro.append(m)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(iter_size)
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                       for k in per_micro[0]}
        grads = {name: p.grad for name, p in model.named_parameters()}
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grads_fn


def reduce_over_mesh(model: nn.Module, metrics: Metrics,
                     mesh: Mesh) -> Metrics:
    """The gradients in ``.grad`` and the metrics, summed over the mesh and
    divided by ``data`` (counts, the keys ending in "_px", only summed): one
    all-reduce per dtype of the gradients, one for the metrics."""
    import torch.distributed as dist
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.data
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(vals, group=mesh.group)
    return {k: v if k.endswith("_px") else v / mesh.data
            for k, v in zip(keys, vals)}


def make_train_step(cfg: TrainConfig, mesh: Optional[Mesh] = None,
                    with_seg: bool = False,
                    preprocessing: str = "demean",
                    label_offset: int = 0) -> Callable:
    """The step: (state, batch) -> (state, metrics), updating ``state`` and
    its model in place.  On a ``mesh`` the batch is this rank's share
    (``torchfcn.parallel.shard_batch``) and the gradients and metrics are
    reduced over the mesh before the update (``reduce_over_mesh``).

    batch (tensors on the model's device):
      image: (B, H, W, 3) uint8 or float raw BGR;
      rects: (B, M, 4) float GT boxes (x, y, w, h);
      labels: (B, M) integer class ids; valid: (B, M) bool;
      seg: (B, H, W) integer masks (only with ``with_seg``).
    With ``cfg.iter_size > 1`` every leaf has a leading (iter_size, ...)
    micro-batch axis (``make_grads_fn``).
    """
    grads_fn = make_grads_fn(
        make_loss_fn(cfg, with_seg, preprocessing, label_offset, mesh),
        cfg.iter_size)
    schedule = make_schedule(cfg)

    def step(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        with state.policy.precision():
            state.model.train()
            _, metrics = grads_fn(state.model, batch, state.generator)
            if mesh is not None:
                metrics = reduce_over_mesh(state.model, metrics, mesh)
            apply_update(state.optimizer, schedule, state.step)
        state.step += 1
        return state, metrics

    return step


def make_multi_train_step(cfg: TrainConfig, mesh=None,
                          with_seg: bool = False,
                          preprocessing: str = "demean",
                          label_offset: int = 0) -> Callable:
    """N train steps per call: (state, stacked batch) -> (state, metrics),
    the batch leaves with a leading (N, B, ...) steps axis and the metrics
    stacked (N,) per key.  A loop of ``make_train_step``'s steps (PyTorch
    runs eagerly; the JAX package's ``lax.scan`` amortised dispatches)."""
    if cfg.iter_size > 1:
        raise ValueError(
            "iter_size > 1 is not supported with multi-step dispatch: pick "
            "gradient accumulation OR several steps per call")
    step = make_train_step(cfg, mesh, with_seg, preprocessing, label_offset)

    def multi(state: TrainState, stacked) -> Tuple[TrainState, Metrics]:
        per_step = []
        for i in range(len(stacked["image"])):
            state, m = step(state, {k: v[i] for k, v in stacked.items()})
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return multi


def stack_batches(batches):
    """[{k: (B, ...)}] -> {k: (N, B, ...)}: tensors stack on their device,
    numpy arrays on the host; the dict type of the first batch (a
    ``LocalBatch`` stays one)."""
    out = type(batches[0])()
    for k in batches[0]:
        vals = [b[k] for b in batches]
        out[k] = (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                  else np.stack(vals))
    return out


def init_state(model: nn.Module, cfg: TrainConfig, rng_seed: int = 0,
               device="cuda",
               policy: Optional[DTypePolicy] = None) -> TrainState:
    """The seeded Caffe "xavier" init of ``model`` (from ``rng_seed``)
    under ``policy`` (default: float32 parameters, bf16 compute),
    ``channels_last`` on ``device``, with a fresh optimizer and a dropout
    generator on that device seeded from ``rng_seed``."""
    device = port_device(device, "training")
    policy = policy or DTypePolicy()
    model.init_weights(torch.Generator().manual_seed(rng_seed))
    policy.apply(model)
    model.to(device=device, memory_format=torch.channels_last)
    return TrainState(
        model=model, optimizer=make_optimizer(cfg, model.parameters()),
        generator=torch.Generator(device=device).manual_seed(rng_seed),
        policy=policy)
