"""The Trainer of the port (``tpufcn/train/trainer.py``): the solver
loop around the train step, snapshots, resume and metrics.

Snapshots are ``torch.save`` files ``<snapshot_dir>/<step>.pt`` holding the
step, the parameters, the optimizer state and the dropout generator's
state; the last 5 are kept.  ``fit`` resumes from the latest, saves
periodically and at the end, and on SIGTERM/SIGINT saves and returns.  The
console display follows the Caffe solver's (``display: 20``, a loss
averaged over the last 20 iterations).

On a (data, space) mesh (``tpufcn/train/trainer.py:142-174,251-270``) every
rank runs a Trainer over the same batch source: ``put`` keeps the rank's
share of each global batch, the step reduces the gradients over the mesh,
rank 0 writes the snapshots, the display and ``BEST.json``, and the ranks
agree on a stop and on the validator's scores (rank 0's, broadcast).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from torchfcn.core.config import TrainConfig
from torchfcn.core.device import port_device
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.core.mesh import Mesh, make_mesh
from torchfcn.models import build as build_model, get_spec
from torchfcn.parallel.distributed import (
    LocalBatch, shard_batch, shard_params_replicated)
from torchfcn.train.step import (
    TrainState, init_state, make_train_step, stack_batches)

KEEP_SNAPSHOTS = 5


def snapshot_steps(snapshot_dir: str) -> List[int]:
    """The steps of the snapshots in ``snapshot_dir``, ascending."""
    if not os.path.isdir(snapshot_dir):
        return []
    return sorted(int(name[:-3]) for name in os.listdir(snapshot_dir)
                  if name.endswith(".pt") and name[:-3].isdigit())


def load_snapshot(snapshot_dir: str, step: Optional[int] = None) -> dict:
    """The snapshot of ``step`` (default: the latest), on the CPU."""
    if step is None:
        steps = snapshot_steps(snapshot_dir)
        if not steps:
            raise FileNotFoundError(f"no snapshots in {snapshot_dir}")
        step = steps[-1]
    return torch.load(os.path.join(snapshot_dir, f"{step}.pt"),
                      map_location="cpu", weights_only=True)


def load_snapshot_params(snapshot_dir: str, step: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """The parameters of a Trainer snapshot (the latest, or ``step``) as a
    state dict on the CPU: the serving weight path (the ``.caffemodel``
    one is ``torchfcn.convert``)."""
    return load_snapshot(snapshot_dir, step)["params"]


class MetricLogger:
    """The solver's smoothed-loss display and throughput meters."""

    def __init__(self, log_every: int = 20, avg_window: int = 20,
                 sink: Callable[[str], None] = print):
        self.log_every = log_every
        self.avg_window = avg_window
        self.window: list = []
        self.sink = sink
        self._t0 = time.perf_counter()
        self._imgs = 0
        self._step0: Optional[int] = None   # steps done before this fit
        self.history: list = []

    def update(self, step: int, metrics: Dict[str, torch.Tensor],
               batch_size: int) -> None:
        self._imgs += batch_size
        if self._step0 is None:
            self._step0 = step - 1
        # the loss over the last avg_window iterations, kept on the device
        # until a display: reading it every step would wait for each step
        self.window = (self.window + [metrics["loss_total"]])[
            -self.avg_window:]
        if step % self.log_every:
            return
        self.window = [float(v) for v in self.window]
        vals = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - self._t0
        ips = self._imgs / dt if dt > 0 else 0.0
        done = max(step - self._step0, 1)
        self.history.append({"step": step, **vals, "img_per_sec": ips})
        self.sink(f"iter {step}: loss={self.smoothed_loss():.6f} "
                  + " ".join(f"{k}={v:.5f}" for k, v in vals.items()
                             if k != "loss_total")
                  + f" ({ips:.1f} img/s, {dt / done * 1000:.1f} ms/it)")

    def smoothed_loss(self) -> float:
        """The mean loss of the last ``avg_window`` iterations."""
        return float(np.mean([float(v) for v in self.window]))

    def log_scalars(self, step: int, vals: Dict[str, float]) -> None:
        """An out-of-band record (validation metrics), printed whatever the
        display cadence."""
        self.history.append({"step": step, **vals})
        self.sink(f"iter {step}: " + " ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in vals.items()))


def _silent(_: str) -> None:
    """The display of a rank that is not rank 0."""


class Trainer:
    """End-to-end training over a batch iterator on one device: host
    batches, or batches on the device such as
    ``iter(DeviceBatchCache(trainer.put, iter(pipe), n))`` over a
    ``torchfcn.data.device_compositor.DeviceCompositePipeline``.

    ``policy`` (default ``DTypePolicy()``: float32 parameters, bf16
    compute) sets how the model computes; ``device`` defaults to "cuda"
    and raises without CUDA ("cpu" runs the kernels' plain versions).
    ``validator`` is a callable taking the model (in eval mode) and
    returning ``{metric: float}``; it runs every ``cfg.eval_every`` steps,
    and the best-scoring snapshot is kept in ``<snapshot_dir>/best``.
    ``mesh`` (a ``torchfcn.core.mesh.Mesh``), or ``cfg.mesh`` naming more
    than one device (then ``make_mesh(cfg.mesh)`` over the initialised
    process group), trains data-parallel and row-sharded; the device is
    then the mesh's.
    """

    def __init__(self, cfg: TrainConfig,
                 model=None,
                 mesh=None,
                 with_seg: bool = False,
                 validator: Optional[Callable] = None,
                 val_metric: Optional[str] = None,
                 log_sink: Callable[[str], None] = print,
                 policy: Optional[DTypePolicy] = None,
                 device="cuda"):
        if mesh is None and cfg.mesh.num_devices > 1:
            mesh = make_mesh(cfg.mesh)
        self.mesh: Optional[Mesh] = mesh
        # rank 0 writes the snapshots and the display
        self.writer = mesh is None or mesh.rank == 0
        self.cfg = cfg
        self.model = model if model is not None else build_model(cfg.model)
        if getattr(self.model, "store_dtype", None) is not None:
            raise ValueError(
                f"model '{cfg.model}' has store_dtype="
                f"{self.model.store_dtype}: fp8 activation storage is a "
                "serving-only mode (the JAX package refuses to train it, and "
                "the stem-tail kernel has no backward); train the exact "
                "model, whose snapshots load into the serving preset")
        self.device = mesh.device if mesh is not None \
            else port_device(device, cfg.model)
        self.policy = policy or DTypePolicy()
        self.with_seg = with_seg
        try:
            spec = get_spec(cfg.model)
            preprocessing, bg = spec.preprocessing, spec.background_channel
        except KeyError:
            preprocessing, bg = "demean", None
        # background-channel families train with object ids shifted past
        # the background channel (make_loss_fn's label_offset)
        if bg not in (None, 0):
            raise ValueError(
                f"background_channel={bg}: only channel 0 is supported as "
                "the background (the label-offset convention)")
        self.step_fn = make_train_step(cfg, mesh, with_seg=with_seg,
                                       preprocessing=preprocessing,
                                       label_offset=0 if bg is None else 1)
        self.logger = MetricLogger(
            cfg.log_every, sink=log_sink if self.writer else _silent)
        self.ckpt_dir = os.path.abspath(cfg.snapshot_dir)
        self.validator = validator
        self.val_metric = val_metric
        self.best: Optional[Dict] = None
        if validator is not None and not cfg.eval_every:
            raise ValueError(
                "a validator was given but cfg.eval_every is 0: set "
                "TrainConfig.eval_every to the validation cadence")

    # --- snapshots (the reference solver's .caffemodel/.solverstate) ---
    def _save_to(self, directory: str, state: TrainState, keep: int) -> None:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{state.step}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)      # no reader sees a half-written file
        for old in snapshot_steps(directory)[:-keep]:
            os.remove(os.path.join(directory, f"{old}.pt"))

    def save(self, state: TrainState) -> None:
        if self.writer:
            self._save_to(self.ckpt_dir, state, KEEP_SNAPSHOTS)

    def restore_latest(self, state: TrainState) -> TrainState:
        """``state`` with the latest snapshot's step, parameters, optimizer
        and generator state, or unchanged without a snapshot."""
        if snapshot_steps(self.ckpt_dir):
            state.load_state_dict(load_snapshot(self.ckpt_dir))
        return state

    def _run_validation(self, state: TrainState, step: int) -> None:
        """Score held-out data and keep the best snapshot in
        ``<snapshot_dir>/best``, with ``BEST.json`` beside it."""
        state.model.eval()
        try:
            with torch.no_grad(), state.policy.precision():
                scores = self.validator(state.model)
        finally:
            state.model.train()
        metrics = {k: int(v) if isinstance(v, (int, np.integer))
                   else float(v) for k, v in scores.items()}
        if self.mesh is not None:
            # every rank scored its replica; rank 0's scores decide "best"
            import torch.distributed as dist
            box = [metrics]
            dist.broadcast_object_list(box, src=0, group=self.mesh.group,
                                       device=self.mesh.device)
            metrics = box[0]
        self.logger.log_scalars(
            step, {f"val_{k}": v for k, v in metrics.items()})
        key = self.val_metric or next(iter(metrics))
        score = float(metrics[key])
        if self.best is None or score > self.best["score"]:
            self.best = {"step": int(step), "score": score, "metric": key}
            if self.writer:
                self._save_to(os.path.join(self.ckpt_dir, "best"), state, 1)
                with open(os.path.join(self.ckpt_dir, "BEST.json"),
                          "w") as f:
                    json.dump({**self.best, "metrics": metrics}, f)

    def init_state(self) -> TrainState:
        """The seeded state; on a mesh every rank then holds rank 0's
        parameters."""
        state = init_state(self.model, self.cfg, rng_seed=self.cfg.seed,
                           device=self.device, policy=self.policy)
        if self.mesh is not None:
            shard_params_replicated(state.model, self.mesh)
        return state

    def put(self, batch: Dict, stacked: bool = False
            ) -> Dict[str, torch.Tensor]:
        """Batch -> tensors on the device (images stay uint8 until the
        step's preprocessing, so transfers stay small); "seg" only when
        training the seg head.  Tensors already on the device (the device
        compositor's, a ``DeviceBatchCache``'s) are taken as they are, not
        copied.  On a mesh only this rank's share moves
        (``torchfcn.parallel.shard_batch``; a ``LocalBatch`` is one
        already); ``stacked`` batches keep their leading steps or
        micro-batch axis whole.  The result is a ``LocalBatch``: putting it
        again moves and shards nothing."""
        return LocalBatch(
            {k: torch.as_tensor(v).to(self.device, non_blocking=True)
             for k, v in shard_batch(batch, self.mesh, stacked).items()
             if k != "seg" or self.with_seg})

    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            max_iter: Optional[int] = None,
            state: Optional[TrainState] = None,
            resume: bool = True) -> TrainState:
        """Run the solver loop to ``max_iter`` (default ``cfg.max_iter``)
        steps.  In the main thread, SIGTERM and SIGINT ask for a stop: the
        current step finishes, a snapshot is saved and fit returns (a later
        ``fit(resume=True)`` continues).  The previous handlers come back
        on exit."""
        max_iter = max_iter or self.cfg.max_iter
        state = state or self.init_state()
        if resume:
            state = self.restore_latest(state)
        if self.logger._step0 is None:
            self.logger._step0 = state.step
        stop: list = []
        previous = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(
                    sig, lambda signum, frame: stop.append(signum))
        try:
            return self._fit_loop(iter(batches), max_iter, state, stop)
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _agree(self, flag: bool) -> bool:
        """Whether any rank of the mesh raised ``flag`` (a signal reaches
        one process): every rank then stops at the same step."""
        if self.mesh is None:
            return flag
        import torch.distributed as dist
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(t.item())

    def _next_group(self, it, n: int) -> Optional[list]:
        """The next ``n`` host batches, or None when the source runs out
        first (with a note if it ran out inside the group)."""
        group = []
        for batch in it:
            group.append(batch)
            if len(group) == n:
                return group
        if group:
            self.logger.sink(
                f"note: the source ran out {n - len(group)} batch(es) short "
                f"of a group of {n}; those {len(group)} were not trained")
        return None

    def _fit_loop(self, it, max_iter: int, state: TrainState,
                  stop: list) -> TrainState:
        cfg = self.cfg
        start = last_snap = last_eval = state.step
        # one step consumes iter_size micro-batches, stacked to
        # (iter_size, B, ...) when there are several
        n = max(cfg.iter_size, 1)
        while state.step < max_iter:
            group = self._next_group(it, n)
            if group is None:
                break
            batch = self.put(stack_batches(group), stacked=True) if n > 1 \
                else self.put(group[0])
            state, metrics = self.step_fn(state, batch)
            shards = 1 if self.mesh is None else self.mesh.data
            self.logger.update(state.step, metrics,
                               n * shards * batch["image"].shape[-4])
            if cfg.snapshot_every and state.step % cfg.snapshot_every == 0:
                self.save(state)
                last_snap = state.step
            if self.validator is not None and \
                    state.step % cfg.eval_every == 0:
                self._run_validation(state, state.step)
                last_eval = state.step
            if self._agree(bool(stop)):
                stop = stop or [signal.SIGTERM]
                self.save(state)
                last_snap = state.step
                self.logger.sink(f"signal {stop[0]}: snapshot saved at step "
                                 f"{state.step}, stopping")
                break
        if state.step > start and last_snap != state.step:
            self.save(state)
        # the solver also tests at exit
        if self.validator is not None and state.step > start \
                and last_eval != state.step:
            self._run_validation(state, state.step)
        if self.mesh is not None:
            # no rank returns before rank 0's last snapshot is written
            import torch.distributed as dist
            dist.barrier(group=self.mesh.group)
        return state
