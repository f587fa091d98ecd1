"""The port's entry points (``__graft_entry__.py``).

``entry()``: the flagship serving pipeline as one function and its
arguments.

    fn, (params, frames) = entry()
    result = fn(params, frames)       # DetectionResult on the card

``Detector("googlenet_detectnet", max_candidates=256)`` in bf16 on
``device`` (the card by default; "cpu" runs the kernels' plain versions):
preprocess -> forward -> decode -> top-K -> groupRectangles NMS ->
rescale, with the parameters as an explicit input
(``Detector.forward_fn``), on a zero batch of 8 448x448 uint8 BGR frames.

``dryrun_multichip(n)``: the (data, space) mesh on ``n`` ranks, one
process each, joined by gloo on the CPU (the JAX package's runs on a
virtual CPU mesh): one sharded train step of ``vgg_detectnet_train`` at
64x64 (data parallel, rows over ``space = 2`` when ``n`` is even), one step
from a batch composed on the mesh, the row-sharded forward, and the
data-parallel and row-sharded Detectors.
"""

from __future__ import annotations

import numpy as np
import torch

BATCH, NET, K = 8, 448, 256


def entry(device="cuda"):
    from torchfcn.serve.detector import Detector
    det = Detector("googlenet_detectnet", dtype=torch.bfloat16,
                   max_candidates=K, device=device)
    fn, params = det.forward_fn()
    frames = torch.zeros((BATCH, NET, NET, 3), dtype=torch.uint8,
                         device=det.device)
    return fn, (params, frames)


def _dryrun_rank(n_devices: int) -> dict:
    """One rank of ``dryrun_multichip`` (every rank runs the same code)."""
    from torchfcn.core.config import (
        DataConfig, DetectorConfig, GridConfig, MeshConfig, TrainConfig)
    from torchfcn.core.dtypes import DTypePolicy
    from torchfcn.core.mesh import make_mesh
    from torchfcn.data.device_compositor import (
        CropLibrary, DeviceCompositePipeline)
    from torchfcn.models import build
    from torchfcn.parallel.distributed import shard_batch, split_rows
    from torchfcn.serve.detector import Detector
    from torchfcn.train.step import init_state, make_train_step

    space = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data = n_devices // space
    mesh = make_mesh(MeshConfig(data=data, space=space))
    grid = GridConfig(im_width=64, im_height=64, stride=8, num_classes=2)
    cfg = TrainConfig(grid=grid, model="vgg_detectnet_train")
    policy = DTypePolicy.parity()
    state = init_state(build("vgg_detectnet_train", num_classes=2), cfg,
                       device=mesh.device, policy=policy)
    step = make_train_step(cfg, mesh)

    # the batch divides over the data axis (n = 3 -> data = 3 -> B = 6)
    b = data * max(2, -(-(2 * n_devices) // data))
    rng = np.random.default_rng(0)
    raw = {"image": (rng.random((b, 64, 64, 3)) * 255).astype(np.uint8),
           "rects": np.tile(np.array([8.0, 8.0, 24.0, 24.0], np.float32),
                            (b, 4, 1)),
           "labels": np.zeros((b, 4), np.int32),
           "valid": np.tile(np.array([True, False, False, False]), (b, 1))}
    local = {k: torch.as_tensor(v) for k, v in shard_batch(raw, mesh).items()}
    state, metrics = step(state, local)
    losses = [float(metrics["loss_total"])]

    # a batch composed on the mesh: each rank composes its share
    crop = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    mask = np.zeros((24, 32), np.uint8)
    mask[4:20, 6:26] = 255
    backgrounds = (rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)
    pipe = DeviceCompositePipeline(
        CropLibrary.from_arrays([crop], [mask], [0]), backgrounds, grid,
        DataConfig(batch_size=b), box_capacity=4, mesh=mesh)
    composed = {k: v for k, v in pipe.batch(b).items() if k != "seg"}
    state, metrics = step(state, composed)
    losses.append(float(metrics["loss_total"]))

    # the row-sharded forward (the JAX package's spatial_infer_sharding)
    x = torch.as_tensor(rng.random((b, 64, 64, 3), dtype=np.float32))
    state.model.eval()
    with torch.no_grad(), policy.precision():
        out = state.model(split_rows(x, mesh), mesh=mesh)
    finite = bool(torch.isfinite(out["coverage"]).all())

    # the serving pipelines: data parallel over every rank, then row
    # sharded over the (data, space) mesh
    dcfg = DetectorConfig(grid=grid, model="vgg_detectnet_train",
                          max_candidates=32)
    dmesh = make_mesh(MeshConfig(data=n_devices, space=1))
    counts = {}
    for name, m, per in (("dp", dmesh, n_devices), ("spatial", mesh, data)):
        det = Detector("vgg_detectnet_train", config=dcfg,
                       dtype=torch.float32, model_kwargs={"num_classes": 2},
                       mesh=m)
        det.model.load_state_dict(state.model.state_dict())
        frames = (rng.random((per * max(2, -(-8 // per)), 64, 64, 3))
                  * 255).astype(np.uint8)
        counts[name] = (int(det(frames).boxes.shape[0]), len(frames))
    return {"losses": losses, "finite": finite, "served": counts,
            "mesh": dict(mesh.shape)}


def dryrun_multichip(n_devices: int) -> list:
    """The sharded train step, a composed batch, the row-sharded forward
    and both meshed Detectors on ``n_devices`` gloo CPU ranks; raises if a
    loss is not finite or a Detector's batch comes back short.  Returns
    each rank's summary."""
    from torchfcn.parallel.distributed import run_ranks
    results = run_ranks(_dryrun_rank, n_devices, n_devices, device="cpu",
                        threads=1)
    for r in results:
        if not (np.isfinite(r["losses"]).all() and r["finite"]):
            raise RuntimeError(f"a sharded step or forward is not finite: "
                               f"{r}")
        for name, (got, want) in r["served"].items():
            if got != want:
                raise RuntimeError(f"the {name} Detector returned {got} of "
                                   f"{want} frames")
    return results
