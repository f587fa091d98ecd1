"""``build(name)(x, mesh=...)`` row-sharded over 2 gloo CPU ranks for
every name of the zoo, ``_serving`` presets included, against the same
model unsharded on the same weights (the port alone), at a small frame
whose rows split unevenly (96 rows: bands of 64 and 32; the pyramid at
448x448, where it closes: 224 + 224).  The float32 nets: coverage within
1e-5 and bboxes within 1e-4 of 1 plus the head's largest magnitude, seg
and score within 1e-4 of theirs (measured at most 2.2e-6 of scale).  The
presets (e5m2 storage, bf16 compute): within 1e-5 of each head's largest
magnitude, as ``tests/test_torch_spatial.py`` holds the GoogLeNet preset
(a bf16 conv over a band may sum in another order than over the whole
frame; measured at most 9e-8 of scale)."""

import numpy as np
import pytest
import torch

from torchfcn.models import build, get_spec, names
from torchfcn.parallel.distributed import run_ranks

from test_torch_mesh_ranks import POLICIES, rank_forward

torch.set_num_threads(2)

TOL = {"coverage": 1e-5, "bboxes": 1e-4}
SCALED = 1e-4              # seg and score, of their largest magnitude
PRESET_TOL = 1e-5          # bf16 + e5m2 presets, of each head's scale


def _size(name):
    """Each family's small frame: rows that split unevenly over 2 ranks,
    the pyramid at 448x448."""
    if name.startswith("vgg_pyramid"):
        return 448, 448
    return 96, 48 if name.startswith(("googlenet", "vgg")) else 64


@pytest.mark.parametrize("name", names())
def test_every_zoo_name_row_shards(name):
    """``build(name)(x, mesh=...)`` on 2 ranks, bands 64 + 32 (the pyramid
    224 + 224), against the same model unsharded."""
    preset = name.endswith("_serving")
    policy = "bf16" if preset else "parity"
    h, w = _size(name)
    model = build(name)
    model.init_weights(torch.Generator().manual_seed(1))
    POLICIES[policy].apply(model)
    scale = 255.0 if get_spec(name).preprocessing == "shift127" else 1.0
    x = torch.from_numpy(np.random.default_rng(2).random(
        (1, h, w, 3), dtype=np.float32) * scale)
    with torch.no_grad(), POLICIES[policy].precision():
        whole = model.to(memory_format=torch.channels_last)(x)
    got = run_ranks(rank_forward, 2, name, model.state_dict(),
                    {}, x, 1, 2, policy, threads=1)
    assert sorted(got[0]) == sorted(whole)
    for key, want in whole.items():
        sharded = torch.cat([g[key] for g in got], dim=1)
        want = want.float()
        assert sharded.shape == want.shape and bool(sharded.isfinite().all())
        scale = float(want.abs().max())
        if preset:
            bound = PRESET_TOL * scale
        elif key in TOL:
            bound = TOL[key] * (1 + scale)
        else:
            bound = SCALED * scale
        assert float((sharded - want).abs().max()) <= bound, key
