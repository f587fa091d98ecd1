"""Rank programs of the port's multi-process tests, and the tests of the
process harness itself.

``torchfcn.parallel.run_ranks`` spawns fresh processes that import the
function they run by its module: the programs live here, in a module that
imports torch and torchfcn only, so that a rank does not pay for importing
JAX.  The test files that compare the port with tpufcn
(``test_torch_mesh.py``, ``test_torch_halo.py``, ``test_torch_spatial.py``,
``test_torch_distributed_train.py``, ``test_torch_distributed_serving.py``)
call them through ``run_ranks(..., threads=1)`` on gloo CPU ranks."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torchfcn.core.config import DataConfig, GridConfig, MeshConfig
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.core.mesh import local_batch, make_mesh, row_bands
from torchfcn.parallel import halo
from torchfcn.parallel.distributed import (
    all_gather_bands, all_reduce_sum, initialize_distributed, run_ranks,
    shard_batch, split_rows)

POLICIES = {
    "parity": DTypePolicy.parity(),
    "f64": DTypePolicy(param_dtype=torch.float64,
                       compute_dtype=torch.float64),
    "bf16": DTypePolicy(param_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16),
}


def mesh_of(data, space):
    return make_mesh(MeshConfig(data, space))


# --- the layout ---

def rank_layout(data, space):
    """(rank, data index, space index, data group ranks, space group ranks)
    and the errors of an oversized mesh and of an uneven batch."""
    mesh = mesh_of(data, space)
    peers = []
    for group in (mesh.data_group, mesh.space_group):
        ranks = torch.zeros(dist.get_world_size(group), dtype=torch.int64)
        parts = list(ranks.split(1))
        dist.all_gather(parts, torch.tensor([mesh.rank]), group=group)
        peers.append([int(p) for p in parts])
    errors = []
    for call in (lambda: make_mesh(MeshConfig(2 * data, 2 * space)),
                 lambda: local_batch(data * 2 + 1, mesh)):
        try:
            call()
        except ValueError as e:
            errors.append(str(e))
    return (mesh.rank, mesh.data_index, mesh.space_index, *peers, errors,
            local_batch(4 * data, mesh))


# --- the halo exchange ---

def rank_halo(x, top, bottom, fill, weight, space):
    """This rank's rows of ``x`` extended by the halo, and the gradient of
    sum(extended * weight[rank]) with respect to its rows."""
    mesh = mesh_of(1, space)
    rows = x.shape[-2] // space
    mine = x[..., mesh.space_index * rows:(mesh.space_index + 1) * rows, :]
    mine = mine.clone().requires_grad_(True)
    ext = halo.halo_rows(mine, top, bottom, mesh, fill)
    (ext * weight[mesh.space_index][..., :ext.shape[-2], :]).sum().backward()
    return (ext.detach(), mine.grad,
            halo.attached(top, bottom, mesh, fill))


def rank_halo_bands(x, top, bottom, fill, bottom_edge, weight, space):
    """``rank_halo`` on this rank's band of ``row_bands(rows, space)``,
    with ``bottom_edge`` rows of fill below the frame."""
    mesh = mesh_of(1, space)
    first, n = row_bands(x.shape[-2], space)[mesh.space_index]
    mine = x[..., first:first + n, :].clone().requires_grad_(True)
    ext = halo.halo_rows(mine, top, bottom, mesh, fill, bottom_edge)
    (ext * weight[mesh.space_index][..., :ext.shape[-2], :]).sum().backward()
    return (ext.detach(), mine.grad,
            halo.attached(top, bottom, mesh, fill, bottom_edge))


# --- the collectives of uneven bands ---

def rank_gather_bands(parts, dim):
    """``all_gather_bands`` of this rank's part."""
    mesh = mesh_of(1, len(parts))
    return all_gather_bands(parts[mesh.space_index], mesh.space_group, dim)


def rank_all_reduce(xs, weights):
    """The gradient of sum(all_reduce_sum(x)^2 * w) with respect to this
    rank's x, where each rank's loss holds its own w."""
    mesh = mesh_of(1, len(xs))
    x = xs[mesh.space_index].clone().requires_grad_(True)
    y = all_reduce_sum(x, mesh.space_group)
    (y * y * weights[mesh.space_index]).sum().backward()
    return y.detach(), x.grad


def rank_group_norm(x, weight, bias, gout, space):
    """The row-sharded GroupNorm of this rank's band of ``x`` (NCHW,
    ``row_bands``): its output rows and the gradients of sum(out * gout)
    with respect to its rows, scale and bias."""
    from torchfcn.models.layers import GroupNorm
    mesh = mesh_of(1, space)
    first, n = row_bands(x.shape[-2], space)[mesh.space_index]
    gn = GroupNorm(x.shape[1])
    with torch.no_grad():
        gn.weight.copy_(weight)
        gn.bias.copy_(bias)
    mine = x[:, :, first:first + n].clone().requires_grad_(True)
    out = gn(mine, mesh)
    (out * gout[:, :, first:first + n]).sum().backward()
    return out.detach(), mine.grad, gn.weight.grad, gn.bias.grad


# --- models ---

def _model(name, state, kwargs, policy, device):
    from torchfcn.models import build
    model = build(name, **kwargs)
    policy.apply(model)
    model.load_state_dict(state)
    return model.to(device=device, memory_format=torch.channels_last)


def rank_forward(name, state, kwargs, x, data, space, policy="parity"):
    """This rank's rows of the heads of ``name`` on its share of ``x``."""
    mesh = mesh_of(data, space)
    pol = POLICIES[policy]
    model = _model(name, state, kwargs, pol, mesh.device)
    with torch.no_grad(), pol.precision():
        out = model(split_rows(x, mesh), mesh=mesh)
    return {k: v.float() for k, v in out.items()}


# --- training ---

def rank_train(name, state, kwargs, cfg, batch, data, space, policy,
               preprocessing, steps=1, with_seg=False, label_offset=0):
    """``steps`` steps of the port's train step on this rank's share of
    ``batch`` (with a mesh unless data = space = 1): the parameters after
    them and the last metrics."""
    from torchfcn.train import step as tstep
    mesh = None if data * space == 1 or not dist.is_initialized() \
        else mesh_of(data, space)
    pol = POLICIES[policy]
    model = _model(name, state, kwargs, pol, "cpu")
    st = tstep.TrainState(
        model=model, optimizer=tstep.make_optimizer(cfg, model.parameters()),
        generator=torch.Generator().manual_seed(cfg.seed), policy=pol)
    step = tstep.make_train_step(cfg, mesh, with_seg, preprocessing,
                                 label_offset)
    local = {k: torch.as_tensor(v) for k, v in
             shard_batch(batch, mesh).items()}
    for _ in range(steps):
        st, metrics = step(st, local)
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            {k: float(v) for k, v in metrics.items()})


def compositor(mesh=None, seed=3, hw=64):
    from torchfcn.data.device_compositor import (
        CropLibrary, DeviceCompositePipeline)
    rng = np.random.default_rng(0)
    crops = [(rng.random((24, 32, 3)) * 255).astype(np.uint8),
             (rng.random((30, 20, 3)) * 255).astype(np.uint8)]
    masks = [np.zeros((24, 32), np.uint8), np.zeros((30, 20), np.uint8)]
    masks[0][4:20, 6:26] = 255
    masks[1][3:27, 2:18] = 255
    bgs = (rng.random((3, hw, hw, 3)) * 255).astype(np.uint8)
    return DeviceCompositePipeline(
        CropLibrary.from_arrays(crops, masks, [0, 1]), bgs,
        GridConfig(hw, hw, 8, 2), DataConfig(batch_size=4), box_capacity=4,
        seed=seed, mesh=mesh, device="cpu")


def rank_compose(data, space, n_batches=2, hw=64):
    """This rank's share of the mesh compositor's first batches."""
    pipe = compositor(mesh_of(data, space), hw=hw)
    return [dict(pipe.batch(4)) for _ in range(n_batches)]


def rank_trainer(cfg, batches, data, space, validator_scores=None,
                 cache=0, policy="parity"):
    """A Trainer with ``cfg.mesh = (data, space)`` made from the config
    over ``batches`` (global host batches, or a DeviceBatchCache of
    ``cache`` of them): its first and final parameters, step, best, the
    snapshots in its directory and its mesh's shape."""
    import dataclasses
    from torchfcn.data.pipeline import DeviceBatchCache
    from torchfcn.train.trainer import Trainer, snapshot_steps
    cfg = dataclasses.replace(cfg, mesh=MeshConfig(data, space))
    scores = iter(validator_scores or [])
    validator = None
    if validator_scores:
        rank = dist.get_rank()
        # each rank's validator scores differently: rank 0's must decide
        validator = lambda model: {"mAP": next(scores) + rank}  # noqa: E731
    from torchfcn.models import build
    trainer = Trainer(cfg, build(cfg.model, num_classes=cfg.grid.num_classes),
                      device="cpu", validator=validator,
                      policy=POLICIES[policy], log_sink=lambda s: None)
    src = iter(batches)
    if cache:
        src = iter(DeviceBatchCache(trainer.put, src, cache))
    state = trainer.init_state()
    first = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    state = trainer.fit(src, state=state)
    return (first, {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()},
            state.step, trainer.best, snapshot_steps(cfg.snapshot_dir),
            trainer.mesh.shape if trainer.mesh else None)


# --- serving ---

def rank_detector(name, state, kwargs, config, frames, data, space, dtype):
    """The global DetectionResult of ``Detector(mesh=...)``."""
    from torchfcn.serve.detector import Detector
    det = Detector(name, config=config, dtype=dtype, model_kwargs=kwargs,
                   mesh=mesh_of(data, space))
    det.model.load_state_dict(state)
    return tuple(det(frames))


def rank_launch(spec, frames, rects_topic, overlay_topic=None):
    """The launch graph of ``spec`` on every rank: rank 0 publishes
    ``frames`` and closes the graph, the other ranks follow.  Rank 0's
    published rects (and, with ``overlay_topic``, its overlays as
    (stamp, image)), or the frames a follower ran."""
    from torchfcn.serve.launch import launch
    graph = launch(spec)
    node = next(iter(graph.nodes.values()))
    if node.following:
        return node.follow()
    got, overlays = [], []
    graph.bus.subscribe(rects_topic, lambda m: got.append(m), queue_size=64)
    if overlay_topic:
        graph.bus.subscribe(overlay_topic, lambda m: overlays.append(
            (m.stamp, m.data)), queue_size=64)
    for i, f in enumerate(frames):
        graph.bus.publish("image", f, stamp=float(i))
        graph.spin()
    graph.close()
    graph.spin()
    rects = [(m.stamp, m.data.points, m.data.labels) for m in got]
    return (rects, overlays) if overlay_topic else rects


# --- the harness ---

def _boom():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")


def test_run_ranks_returns_in_rank_order_and_raises():
    """What each rank returns comes back in rank order; a rank's error is
    raised in the caller, the other ranks stopped."""
    got = run_ranks(dist.get_rank, 2, threads=1)
    assert got == [0, 1]
    with pytest.raises(Exception, match="rank 1 fails"):
        run_ranks(_boom, 2, threads=1)


def test_backend_is_named_not_chosen():
    """NCCL runs on the card only; an unknown backend raises; an explicit
    address needs the world size and the rank; make_mesh needs a group."""
    with pytest.raises(ValueError, match="NCCL backend runs on the card"):
        initialize_distributed(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend must be"):
        initialize_distributed(device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="world_size and rank"):
        initialize_distributed("tcp://localhost:1", device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(MeshConfig())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            initialize_distributed(device="cuda")
