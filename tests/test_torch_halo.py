"""The halo exchange (``torchfcn.parallel.halo``) on 2 and 4 gloo CPU
ranks against the unsharded tensor: each rank's extended rows must equal
the rows of the whole tensor around its band, with the frame's edges
filled as asked (zeros, -inf) or left out (None), exactly; and the gradient
of sum(extended * w) on each rank's rows must equal the gradient of the
same sum taken on the whole tensor, where each halo row's weight lands on
the rank that owns the row (float64, within 1e-12: the sums add at most
three terms per value)."""

import numpy as np
import pytest
import torch

from torchfcn.parallel.distributed import run_ranks

from test_torch_mesh_ranks import rank_halo

ROWS = 4


def _expected(x, space, top, bottom, fill, weight):
    """The extended bands and the gradient on the whole tensor."""
    rows = x.shape[-2] // space
    grad = torch.zeros_like(x)
    bands = []
    for s in range(space):
        lo, hi = s * rows - top, (s + 1) * rows + bottom
        parts, index = [], []
        for r in range(lo, hi):
            if 0 <= r < x.shape[-2]:
                parts.append(x[..., r:r + 1, :])
                index.append(r)
            elif fill is not None:
                parts.append(torch.full_like(x[..., :1, :], fill))
                index.append(None)
        band = torch.cat(parts, dim=-2)
        bands.append(band)
        w = weight[s][..., :band.shape[-2], :]
        for j, r in enumerate(index):
            if r is not None:
                grad[..., r, :] += w[..., j, :]
    return bands, grad


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("top,bottom,fill", [
    (1, 1, 0.0),               # 3x3 conv, pad 1
    (3, 2, 0.0),               # 7x7/2 conv, pad 3
    (1, 1, float("-inf")),     # 3x3/1 max pool, pad 1
    (0, 1, None),              # ceil-mode 3x3/2 pool, the LRN + pool kernel
    (1, 2, None),              # the stem-tail kernel
])
def test_halo_matches_unsharded(space, top, bottom, fill):
    g = torch.Generator().manual_seed(space * 10 + top)
    x = torch.randn((2, 3, ROWS * space, 5), generator=g,
                    dtype=torch.float64)
    weight = torch.randn((space, 2, 3, ROWS + top + bottom, 5), generator=g,
                         dtype=torch.float64)
    got = run_ranks(rank_halo, space, x, top, bottom, fill, weight, space,
                    threads=1)
    bands, grad = _expected(x, space, top, bottom, fill, weight)
    for s, (ext, g_rows, counts) in enumerate(got):
        assert torch.equal(ext, bands[s]), s
        first, last = s == 0, s == space - 1
        want = (0 if first and fill is None else top,
                0 if last and fill is None else bottom)
        assert counts == want
    got_grad = torch.cat([g_rows for _, g_rows, _ in got], dim=-2)
    np.testing.assert_allclose(got_grad.numpy(), grad.numpy(), rtol=0,
                               atol=1e-12)
