"""The (data, space) mesh of the port (``tpufcn/core/mesh.py``) on
``torch.distributed``: one process per rank.

* ``data``: batch data parallelism; gradients are summed over the mesh
  after each rank's backward (``torchfcn.train.step``).
* ``space``: row sharding of the activations (H) of one frame; the convs
  and pools of a rank read halo rows of its neighbours
  (``torchfcn.parallel.halo``).  ``row_bands`` plans the bands: each but
  the last a multiple of 32 rows, the last the remainder.

Rank ``r`` of the mesh sits at ``(data, space) = divmod(r, space)``, the
row-major layout of the JAX package's ``reshape(data, space)``.  A mesh of
one rank is the trivial case of the same code: its groups are the world
group of one process, and the collectives are still called.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from torchfcn.core.config import MeshConfig

DATA_AXIS = "data"
SPACE_AXIS = "space"


class Mesh:
    """This process's place in a (data, space) layout of the world's ranks
    and the process groups that join it to the others.

    ``data_group`` joins the ranks that hold the same rows of other batch
    shards (one space index), ``space_group`` the row shards of one batch
    shard, ``group`` every rank of the mesh.  ``device`` is this rank's
    device.  Build it with ``make_mesh`` (every rank, in the same order:
    group creation is a collective)."""

    def __init__(self, data: int, space: int, rank: int, groups: dict,
                 device: torch.device):
        self.data, self.space, self.rank = data, space, rank
        self.data_index, self.space_index = divmod(rank, space)
        self.group = groups["mesh"]
        self.data_group = groups["data"]
        self.space_group = groups["space"]
        self.device = torch.device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, SPACE_AXIS: self.space}

    @property
    def size(self) -> int:
        return self.data * self.space

    @property
    def first_row_shard(self) -> bool:
        return self.space_index == 0

    @property
    def last_row_shard(self) -> bool:
        return self.space_index == self.space - 1

    def band(self, rows: int) -> Tuple[int, int]:
        """(offset, rows) of this rank's band of a frame of ``rows`` rows
        (``row_bands``); the whole frame without row sharding."""
        if self.space == 1:
            return 0, rows
        return row_bands(rows, self.space)[self.space_index]


def make_mesh(cfg: Optional[MeshConfig] = None, device=None) -> Mesh:
    """The (data, space) mesh over the initialised world
    (``torchfcn.parallel.initialize_distributed``), every rank on the data
    axis without ``cfg``.  ``device`` defaults to the one
    ``initialize_distributed`` chose for this rank.  Raises ValueError when
    the world has another number of ranks than the mesh: each rank is one
    process, and a rank outside the mesh would have no work."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed initialised: call "
            "torchfcn.parallel.initialize_distributed (or run under "
            "torchrun) in every rank first")
    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(data=world, space=1)
    n = cfg.num_devices
    if n > world:
        raise ValueError(f"mesh needs {n} devices ({cfg.data}x{cfg.space}) "
                         f"but only {world} available")
    if n < world:
        raise ValueError(f"mesh names {n} devices ({cfg.data}x{cfg.space}) "
                         f"but the world has {world} ranks: start one "
                         f"process per device of the mesh")
    rank = dist.get_rank()

    def group(ranks):
        # every rank creates every group, in one order (a collective)
        return dist.group.WORLD if len(ranks) == world \
            else dist.new_group(ranks)

    space_groups = [group([d * cfg.space + s for s in range(cfg.space)])
                    for d in range(cfg.data)]
    data_groups = [group([d * cfg.space + s for d in range(cfg.data)])
                   for s in range(cfg.space)]
    d, s = divmod(rank, cfg.space)
    if device is None:
        from torchfcn.parallel.distributed import rank_device
        device = rank_device()
    return Mesh(cfg.data, cfg.space, rank,
                {"mesh": dist.group.WORLD, "data": data_groups[s],
                 "space": space_groups[d]}, device)


def local_batch(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel degree {n}")
    return global_batch // n


def space_sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits a frame's rows over more than one rank."""
    return mesh is not None and mesh.space > 1


# the rows of a band, but the last, are a multiple of this: the deepest
# stride of the zoo (FCN-8s, ResNet-FPN), which every family's divides, so
# that one plan serves every family and every caller that splits a frame
# (the Detector, shard_batch, the mesh compositor, the loss's label bands)
ROW_QUANTUM = 32


def row_bands(rows: int, space: int) -> Tuple[Tuple[int, int], ...]:
    """(offset, rows) of each space rank's band of a frame of ``rows``
    rows.  Every band but the last holds a multiple of ROW_QUANTUM rows,
    the nearest to an even share of what is left; the last holds the
    remainder, which need not divide.  Raises ValueError when the frame
    has fewer ROW_QUANTUM-row units (the last may be partial) than there
    are ranks.  (The JAX package's GSPMD pads uneven shards instead.)"""
    quantum = ROW_QUANTUM
    units = -(-rows // quantum)
    if units < space:
        raise ValueError(
            f"row sharding over space = {space} needs at least {space} "
            f"units of {quantum} rows (the zoo's deepest stride), the last "
            f"may be partial; got {rows} rows ({units} units)")
    bands, offset = [], 0
    for s in range(space - 1):
        left = space - s
        # round half up of an even share, leaving a unit for each rank below
        n = (2 * (rows - offset) + left * quantum) // (2 * left * quantum)
        n = max(1, min(n, -(-(rows - offset) // quantum) - (left - 1)))
        bands.append((offset, n * quantum))
        offset += n * quantum
    bands.append((offset, rows - offset))
    return tuple(bands)


def check_band(rows: int, mesh: Optional[Mesh], stride: int) -> None:
    """A row-sharded model's input band: every band but the frame's last
    must hold a multiple of the net's deepest ``stride``, so that each
    stride-2 layer starts every band on an even row (``row_bands`` plans
    such bands)."""
    if space_sharded(mesh) and not mesh.last_row_shard and rows % stride:
        raise ValueError(
            f"a row band above the frame's last must hold a multiple of the "
            f"net's deepest stride {stride}; got {rows} rows (plan the bands "
            f"with torchfcn.core.mesh.row_bands)")
