"""Uneven row bands of the port's (data, space) mesh and the collectives
that carry them, on gloo CPU ranks.

* ``row_bands``: the plan of each space rank's rows (every band but the
  last a multiple of 32 rows, the last the remainder) and its refusal of
  frames with fewer 32-row units than ranks; ``check_band``, a model's
  check of its input band.
* The halo exchange on uneven bands, with the frame-bottom fill of a
  layer that pads, against the unsharded tensor: exact, and the gradient
  within 1e-12 (float64, at most three terms per value).
* ``all_gather_bands``: bands of other lengths joined, every dtype moved
  as bytes, exactly.
* ``all_reduce_sum``: its gradient on 2 and 3 ranks against one process's
  autograd of the same sum (float64, within 1e-12).
* The row-sharded GroupNorm (sums, sums of squares and counts summed over
  the space group, Flax's fast variance) against ``F.group_norm`` and
  Flax's ``nn.GroupNorm`` on the whole map, float32: outputs within 1e-5,
  gradients within 1e-4 of their largest magnitude (each band sums its
  own share of every statistic, in another order)."""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from torchfcn.core.mesh import Mesh, check_band, row_bands
from torchfcn.parallel.distributed import run_ranks

from test_torch_mesh_ranks import (
    rank_all_reduce, rank_gather_bands, rank_group_norm, rank_halo_bands)

torch.set_num_threads(2)


@pytest.mark.parametrize("rows,space,bands", [
    (288, 2, ((0, 160), (160, 128))),          # fcn8s_bbox: 5 + 4 pool5 rows
    (432, 2, ((0, 224), (224, 208))),          # 27 stride-16 rows: 14 + 13
    (448, 2, ((0, 224), (224, 224))),          # the even split stays
    (96, 2, ((0, 64), (64, 32))),
    (144, 3, ((0, 64), (64, 32), (96, 48))),   # the last unit partial
    (72, 2, ((0, 32), (32, 40))),              # no band left a sliver
    (448, 4, ((0, 128), (128, 96), (224, 128), (352, 96))),
])
def test_row_bands_plan(rows, space, bands):
    got = row_bands(rows, space)
    assert got == bands
    assert sum(n for _, n in got) == rows
    assert all(n % 32 == 0 for _, n in got[:-1]) and got[-1][1] > 0
    assert all(o == sum(n for _, n in got[:i]) for i, (o, _) in
               enumerate(got))


@pytest.mark.parametrize("rows,space", [(32, 2), (64, 3), (1, 2)])
def test_row_bands_refuse_fewer_units_than_ranks(rows, space):
    with pytest.raises(ValueError, match=f"at least {space} units of 32"):
        row_bands(rows, space)


def test_check_band_and_mesh_band():
    """An inner band must hold a multiple of the net's deepest stride; the
    frame's last band may hold any rows.  ``Mesh.band`` is the rank's
    entry of the plan."""
    top = Mesh(1, 2, 0, {"mesh": None, "data": None, "space": None}, "cpu")
    last = Mesh(1, 2, 1, {"mesh": None, "data": None, "space": None}, "cpu")
    check_band(64, top, 32)
    check_band(40, last, 32)
    check_band(40, None, 32)
    with pytest.raises(ValueError, match="deepest stride 32; got 48 rows"):
        check_band(48, top, 32)
    assert top.band(288) == (0, 160) and last.band(288) == (160, 128)


@pytest.mark.parametrize("space,rows", [(2, 96), (3, 144)])
@pytest.mark.parametrize("top,bottom,fill,bottom_edge", [
    (3, 2, 0.0, 3),            # 7x7/2 conv, pad 3: 3 fill rows below
    (1, 0, float("-inf"), 1),  # 3x3/2 floor pool, pad 1
    (1, 0, 0.0, 1),            # 3x3/2 conv, pad 1
    (1, 1, 0.0, None),         # 3x3 conv and the upsampling's halo
    (0, 1, None, None),        # ceil-mode 3x3/2 pool, the LRN + pool kernel
])
def test_halo_on_uneven_bands(space, rows, top, bottom, fill, bottom_edge):
    g = torch.Generator().manual_seed(space * 10 + top)
    x = torch.randn((2, 3, rows, 5), generator=g, dtype=torch.float64)
    bands = row_bands(rows, space)           # 64 + 32, 64 + 32 + 48
    assert len({n for _, n in bands}) > 1
    weight = torch.randn((space, 2, 3, rows + 6, 5), generator=g,
                         dtype=torch.float64)
    got = run_ranks(rank_halo_bands, space, x, top, bottom, fill,
                    bottom_edge, weight, space, threads=1)
    grad = torch.zeros_like(x)
    for s, ((first, n), (ext, _, counts)) in enumerate(zip(bands, got)):
        last = s == space - 1
        t_in = top if s or fill is not None else 0
        b_in = bottom if not last else (
            0 if fill is None else
            bottom if bottom_edge is None else bottom_edge)
        assert counts == (t_in, b_in)
        want = []
        for r in range(first - t_in, first + n + b_in):
            want.append(x[..., r:r + 1, :] if 0 <= r < rows
                        else torch.full_like(x[..., :1, :], fill))
            if 0 <= r < rows:
                grad[..., r, :] += weight[s][..., r - first + t_in, :]
        assert torch.equal(ext, torch.cat(want, dim=-2)), s
    got_grad = torch.cat([g_rows for _, g_rows, _ in got], dim=-2)
    np.testing.assert_allclose(got_grad.numpy(), grad.numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float8_e5m2,
                                   torch.bool])
@pytest.mark.parametrize("dim,lengths", [(1, (3, 1, 2)), (2, (2, 5))])
def test_all_gather_bands_joins_uneven_bands(dtype, dim, lengths):
    g = torch.Generator().manual_seed(len(lengths))
    parts = []
    for n in lengths:
        shape = [2, 3, 4]
        shape[dim] = n
        parts.append((torch.randn(shape, generator=g) * 4).to(dtype))
    got = run_ranks(rank_gather_bands, len(lengths), parts, dim, threads=1)
    want = torch.cat(parts, dim=dim)
    for r in got:
        assert r.dtype == dtype and torch.equal(r, want)


@pytest.mark.parametrize("space", [2, 3])
def test_all_reduce_sum_gradient_matches_one_process(space):
    g = torch.Generator().manual_seed(space)
    xs = torch.randn((space, 3, 4), generator=g, dtype=torch.float64)
    ws = torch.randn((space, 3, 4), generator=g, dtype=torch.float64)
    got = run_ranks(rank_all_reduce, space, xs, ws, threads=1)
    x = xs.clone().requires_grad_(True)
    y = x.sum(0)
    sum((y * y * ws[r]).sum() for r in range(space)).backward()
    for r, (y_r, g_r) in enumerate(got):
        np.testing.assert_allclose(y_r.numpy(), y.detach().numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(g_r.numpy(), x.grad[r].numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("space,rows", [(2, 96), (3, 144)])
def test_sharded_group_norm_matches_torch_and_flax(space, rows):
    g = torch.Generator().manual_seed(rows)
    c = 64
    # an offset and a scale per channel, as a conv's output has
    x = (torch.randn((2, c, rows, 5), generator=g) * 3
         + torch.randn((1, c, 1, 1), generator=g) * 2)
    weight = 1 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    gout = torch.randn(x.shape, generator=g)
    got = run_ranks(rank_group_norm, space, x, weight, bias, gout, space,
                    threads=1)
    out = torch.cat([r[0] for r in got], dim=2)
    gx = torch.cat([r[1] for r in got], dim=2)
    gw, gb = sum(r[2] for r in got), sum(r[3] for r in got)

    xt = x.clone().requires_grad_(True)
    wt, bt = weight.clone().requires_grad_(True), \
        bias.clone().requires_grad_(True)
    want = F.group_norm(xt, 32, wt, bt, 1e-6)
    (want * gout).sum().backward()
    flax_gn = fnn.GroupNorm(num_groups=32, epsilon=1e-6, dtype=jnp.float32)
    params = {"params": {"scale": jnp.asarray(weight.numpy()),
                         "bias": jnp.asarray(bias.numpy())}}
    flax_out = np.asarray(jax.jit(flax_gn.apply)(
        params, jnp.asarray(x.permute(0, 2, 3, 1).numpy())))
    flax_out = flax_out.transpose(0, 3, 1, 2)
    scale = float(want.detach().abs().max())
    for ref in (want.detach().numpy(), flax_out):
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale)
    for got_g, want_g in ((gx, xt.grad), (gw, wt.grad), (gb, bt.grad)):
        np.testing.assert_allclose(
            got_g.numpy(), want_g.numpy(), rtol=0,
            atol=1e-4 * float(want_g.abs().max()))
