"""Multi-process execution of the port (``tpufcn/parallel/distributed.py``)
on ``torch.distributed``: one process per rank.

* ``initialize_distributed``: the handshake, NCCL for the card and gloo
  for the CPU; gloo on the card only when the caller names it (two ranks
  that share one card: NCCL refuses a GPU twice in one communicator).
* ``shard_params_replicated``: the replicated parameter layout (rank 0's
  values broadcast to every rank), the right one for these ~10M-parameter
  convnets.
* ``shard_batch`` / ``split_rows``: a rank's share of a global batch, its
  batch shard and, under row sharding, its band of rows
  (``core.mesh.row_bands``).
* ``all_gather_cat``: the ranks' tensors of a group joined along one axis;
  ``all_gather_bands`` the same for bands of other lengths.
* ``all_reduce_sum``: a sum over a group that autograd differentiates (the
  row-sharded pyramid pools and GroupNorm statistics).
* ``run_ranks``: run a function in N fresh processes joined by a group, and
  collect what each returns (the CPU tests, ``entry.dryrun_multichip``).

The collectives move tensors as bytes (``all_gather_cat``) or as float32,
float64 sums, which both NCCL and gloo carry on CUDA tensors.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from torchfcn.core.device import port_device
from torchfcn.core.mesh import Mesh, space_sharded

_RANK_DEVICE: Optional[torch.device] = None


def initialize_distributed(address: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device="cuda",
                           backend: Optional[str] = None) -> int:
    """Join the process group; returns the world size.

    Without ``address`` the rendezvous is ``env://`` (torchrun's
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE); else ``address``
    ("tcp://localhost:<port>" or "file://<path>") with ``world_size`` and
    ``rank``.  ``backend`` defaults to "nccl" for ``device="cuda"`` and
    "gloo" for "cpu"; "gloo" on "cuda" must be asked for.  On the card,
    "cuda" without an index is the device ``LOCAL_RANK`` (else ``rank``)
    modulo the cards present.  Returns at once when the group exists."""
    global _RANK_DEVICE
    device = port_device(device, "initialize_distributed")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend runs on the card: pass "
                         "device='cuda', or backend='gloo' on the CPU")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if dist.is_initialized():
        return dist.get_world_size()
    if address is None:
        init, kw = "env://", {}
        rank = int(os.environ.get("RANK", 0))
    else:
        if world_size is None or rank is None:
            raise ValueError("an explicit address needs world_size and rank")
        init, kw = address, dict(world_size=world_size, rank=rank)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # a rank that dies leaves the others waiting this long, not forever
    dist.init_process_group(backend, init_method=init,
                            timeout=datetime.timedelta(minutes=10), **kw)
    _RANK_DEVICE = device
    return dist.get_world_size()


def rank_device() -> torch.device:
    """The device ``initialize_distributed`` chose for this rank."""
    if _RANK_DEVICE is None:
        raise RuntimeError("initialize_distributed has not run in this "
                           "process")
    return _RANK_DEVICE


def shutdown_distributed() -> None:
    """Leave the process group (a no-op outside one)."""
    global _RANK_DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None


@torch.no_grad()
def shard_params_replicated(model: torch.nn.Module, mesh: Mesh
                            ) -> torch.nn.Module:
    """Every parameter and buffer of ``model`` set to mesh rank 0's values
    (one broadcast per dtype); returns ``model``."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(model.parameters()) + list(model.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return model


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` (equal shapes) joined along ``dim`` in
    rank order.  Moved as bytes, so every dtype (float8 and bool too)
    passes through either backend unchanged."""
    raw = t.contiguous()
    flat = raw.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return torch.cat([p.view(t.dtype).view(raw.shape) for p in parts],
                     dim=dim)


def band_sizes(n: int, group, device) -> List[int]:
    """Every rank's ``n`` in ``group``, in rank order (one all_gather of an
    integer on ``device``)."""
    return all_gather_cat(torch.tensor([n], device=device), group).tolist()


def all_gather_bands(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """``all_gather_cat`` of bands whose lengths along ``dim`` differ
    between the ranks: each padded to the longest, gathered, then
    trimmed."""
    sizes = band_sizes(t.shape[dim], group, t.device)
    longest = max(sizes)
    if t.shape[dim] < longest:
        pad = list(t.shape)
        pad[dim] = longest - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    parts = all_gather_cat(t, group, dim).split(longest, dim=dim)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                     dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of every rank's x; each rank's y feeds its own part of a
    loss that sums over the ranks, so dL/dx is the sum of every rank's
    dL/dy: the backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def batch_rows(mesh: Optional[Mesh], batch: int, rows: Optional[int] = None):
    """(batch slice, row slice) of this rank in a global batch of ``batch``
    images of ``rows`` rows; the row slice is the whole frame unless the
    mesh shards rows, else this rank's band (``Mesh.band``).  Raises on a
    batch that does not divide and on rows too few to split."""
    from torchfcn.core.mesh import local_batch
    if mesh is None:
        return slice(0, batch), slice(None)
    b = local_batch(batch, mesh)
    bs = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    if not space_sharded(mesh) or rows is None:
        return bs, slice(None)
    offset, n = mesh.band(rows)
    return bs, slice(offset, offset + n)


def split_rows(frames, mesh: Optional[Mesh]):
    """This rank's share of a global (B, H, ...) frame batch: its batch
    shard and, under row sharding, its band of each frame's rows."""
    bs, rs = batch_rows(mesh, frames.shape[0], frames.shape[1])
    return frames[bs, rs]


# keys of a training batch whose second axis is a frame's rows
ROW_KEYS = ("image", "seg")


class LocalBatch(dict):
    """A training batch that holds this rank's share already (a mesh
    compositor's, a ``DeviceBatchCache``'s): ``shard_batch`` passes it
    through."""


def shard_batch(batch: Dict, mesh: Optional[Mesh],
                stacked: bool = False) -> Dict:
    """This rank's share of a global training batch (``tpufcn/train/step.py
    ::batch_sharding``): every leaf's batch shard, and the rows of "image"
    and "seg" under row sharding.  ``stacked`` batches carry a leading
    (N, ...) axis (steps or micro-batches) that every rank keeps whole.  A
    ``LocalBatch`` is returned as it is."""
    if mesh is None or isinstance(batch, LocalBatch):
        return batch
    lead = (slice(None),) if stacked else ()
    b = batch["image"].shape[len(lead)]
    rows = batch["image"].shape[len(lead) + 1]
    bs, rs = batch_rows(mesh, b, rows)
    return LocalBatch({k: v[lead + ((bs, rs) if k in ROW_KEYS else (bs,))]
                       for k, v in batch.items()})


def _rank_main(index: int, fn: Callable, world_size: int, store: str,
               device: str, backend: Optional[str], threads: Optional[int],
               args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    initialize_distributed(f"file://{store}/rendezvous", world_size, index,
                           device=device, backend=backend)
    try:
        result = fn(*args)
    finally:
        shutdown_distributed()
    torch.save(result, os.path.join(store, f"rank{index}.pt"))


def run_ranks(fn: Callable, world_size: int, *args, device="cpu",
              backend: Optional[str] = None, threads: Optional[int] = None
              ) -> list:
    """Run ``fn(*args)`` in ``world_size`` fresh processes (spawned), each
    a rank of one process group on ``device`` ("cpu": gloo; "cuda": NCCL,
    or gloo with ``backend="gloo"``), and return what each returned, in
    rank order.  ``fn`` must be importable (a module-level function); what
    it returns goes back through ``torch.save``.  A rank that raises stops
    the others, and the error is raised here."""
    import torch.multiprocessing as mp
    store = tempfile.mkdtemp(prefix="torchfcn_ranks_")
    try:
        mp.start_processes(_rank_main,
                           args=(fn, world_size, store, str(device), backend,
                                 threads, args),
                           nprocs=world_size, start_method="spawn")
        return [torch.load(os.path.join(store, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(store, ignore_errors=True)
