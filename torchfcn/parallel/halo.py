"""Halo exchange for row-sharded activations: the counterpart of the
collective-permutes that the JAX package's GSPMD inserts around a conv
whose input rows are split over the ``space`` axis.

``halo_rows(x, top, bottom, mesh, fill)`` extends this rank's rows of an
NCHW activation by the last ``top`` rows of the rank above and the first
``bottom`` rows of the rank below.  At the frame's edges the rows are
``fill`` (a conv's zeros, a max pool's -inf), ``top`` of them above and
``bottom_edge`` (by default ``bottom``) below, or absent with
``fill=None`` (a ceil-mode pool or a kernel that pads itself).  The
backward sends each halo's gradient back to the rank that owns those rows
and adds it there.

The bands may differ in length (``core.mesh.row_bands``): only the last
may hold rows that a stride-2 layer does not divide, and a layer that pads
``p`` rows gets ``p`` rows of fill below it (``bottom_edge``), so that its
last band yields the rows the whole frame's last rows would.  The halos
are the same size on every rank, so one equal-sized all_gather still
moves them.

Both directions use one ``all_gather`` of every rank's edge rows within the
space group, moved as bytes: NCCL and gloo both carry it on CUDA tensors,
where gloo has no point-to-point send/recv for them.  Each rank reads the
two parts it needs; the space groups are 2 or 4 ranks, so the extra bytes
are a few edge rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchfcn.core.mesh import Mesh, space_sharded
from torchfcn.parallel.distributed import all_gather_cat


def attached(top: int, bottom: int, mesh: Mesh, fill: Optional[float],
             bottom_edge: Optional[int] = None) -> Tuple[int, int]:
    """The rows ``halo_rows`` puts above and below this rank's rows."""
    if not mesh.last_row_shard:
        below = bottom
    else:
        below = 0 if fill is None else \
            bottom if bottom_edge is None else bottom_edge
    return 0 if mesh.first_row_shard and fill is None else top, below


def _edges(x: torch.Tensor, top: int, bottom: int, mesh: Mesh):
    """Every rank's (first ``bottom`` rows, last ``top`` rows) of ``x``:
    -> (the rank above's last ``top`` rows, the rank below's first
    ``bottom`` rows), None past the frame."""
    rows = x.shape[-2]
    mine = torch.cat([x[..., :bottom, :], x[..., rows - top:, :]], dim=-2)
    every = all_gather_cat(mine[None], mesh.space_group)
    s = mesh.space_index
    above = every[s - 1][..., bottom:, :] if s > 0 else None
    below = every[s + 1][..., :bottom, :] if s < mesh.space - 1 else None
    return above, below


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, top, bottom, mesh, fill, bottom_edge):
        rows = x.shape[-2]
        if top > rows or bottom > rows:
            raise ValueError(f"a halo of {top} + {bottom} rows needs at "
                             f"least that many rows per shard, got {rows}")
        above, below = _edges(x, top, bottom, mesh)
        t_in, b_in = attached(top, bottom, mesh, fill, bottom_edge)

        def edge(part, n):
            if part is not None:
                return [part]
            if n == 0:
                return []
            shape = (*x.shape[:-2], n, x.shape[-1])
            return [torch.full(shape, fill, dtype=x.dtype, device=x.device)]

        parts = edge(above, t_in) + [x] + edge(below, b_in)
        ctx.meta = (top, bottom, mesh, t_in, b_in)
        out = torch.cat(parts, dim=-2)
        return out.contiguous(memory_format=torch.channels_last) \
            if out.dim() == 4 else out

    @staticmethod
    def backward(ctx, grad):
        top, bottom, mesh, t_in, b_in = ctx.meta
        rows = grad.shape[-2] - t_in - b_in
        g = grad[..., t_in:t_in + rows, :].clone()
        # this rank's halo gradients, zeros where a halo was fill
        g_top = grad[..., :top, :] if not mesh.first_row_shard \
            else grad.new_zeros((*grad.shape[:-2], top, grad.shape[-1]))
        g_bot = grad[..., t_in + rows:, :] if not mesh.last_row_shard \
            else grad.new_zeros((*grad.shape[:-2], bottom, grad.shape[-1]))
        # the halo gradients travel back: every rank gathers each rank's
        # (top-halo gradient, bottom-halo gradient)
        every = all_gather_cat(torch.cat([g_top, g_bot], dim=-2)[None],
                               mesh.space_group)
        s = mesh.space_index
        if s > 0:       # the rank above's bottom halo was my first rows
            g[..., :bottom, :] += every[s - 1][..., top:, :]
        if s < mesh.space - 1:    # the rank below's top halo was my last
            g[..., rows - top:, :] += every[s + 1][..., :top, :]
        return g, None, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int,
              mesh: Optional[Mesh], fill: Optional[float] = 0.0,
              bottom_edge: Optional[int] = None) -> torch.Tensor:
    """``x`` (…, H, W) with ``top`` rows of the rank above and ``bottom``
    rows of the rank below; rows past the frame are ``fill`` (``top``
    above it, ``bottom_edge`` or else ``bottom`` below it), or absent when
    ``fill`` is None.  ``x`` itself without row sharding or rows to add."""
    if not space_sharded(mesh) or (top == 0 and bottom == 0
                                   and not bottom_edge):
        return x
    return _HaloRows.apply(x, top, bottom, mesh, fill, bottom_edge)
