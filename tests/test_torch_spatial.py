"""Row-sharded inference of the port on a (data=2, space=2) mesh of gloo
CPU ranks, against tpufcn's ``spatial_infer_sharding`` forward (GSPMD on
``tests/conftest.py``'s virtual CPU devices) on the same weights, float32:
coverage within 1e-5 and bboxes within 1e-4, rtol and atol, as
``tests/test_spatial_inference.py:28-33`` holds tpufcn's sharded forward to
its unsharded one; and against the port's own unsharded forward with the
same bounds.

The e5m2 serving preset (``googlenet_detectnet_serving``, bf16 compute,
the stem tail on halo rows) sharded against unsharded, both the port:
within 1e-5 of each head's largest magnitude (a bf16 conv over a band may
sum in another order than over the whole frame; at these sizes the heads
differ by a float32 ulp or not at all).

Single-process: the plain versions of the two pooling kernels with halo
rows against the unsharded ones (exact), and the stem tail's refusal of an
odd row count.  The other families row-shard too:
``test_torch_spatial_families.py`` and ``test_torch_spatial_zoo.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import MeshConfig as JMeshConfig
from tpufcn.core.mesh import make_mesh as jmake_mesh
from tpufcn.models import build as jax_build
from tpufcn.parallel import shard_params_replicated, spatial_infer_sharding
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.models import build
from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda
from torchfcn.ops.cuda.stem import check_inputs
from torchfcn.ops.stem import stem_tail
from torchfcn.parallel.distributed import run_ranks

from test_torch_mesh_ranks import rank_forward

torch.set_num_threads(2)

TOL = {"coverage": 1e-5, "bboxes": 1e-4}


def _join(parts, data=2, space=2):
    """The ranks' (batch shard, row band) outputs as the global tensor."""
    return torch.cat([torch.cat(parts[d * space:(d + 1) * space], dim=1)
                      for d in range(data)], dim=0)


@pytest.mark.parametrize("name,hw,scale", [
    ("vgg_detectnet_train", 64, 1.0),
    ("googlenet_detectnet", 64, 255.0),
])
def test_spatial_forward_matches_tpufcn(name, hw, scale):
    rng = np.random.default_rng(0)
    x = (rng.random((2, hw, hw, 3), dtype=np.float32) * scale)
    jmodel = jax_build(name, dtype=jnp.float32, num_classes=2)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x))
    mesh = jmake_mesh(JMeshConfig(data=2, space=2),
                      devices=jax.devices("cpu")[:4])
    want = jax.jit(jmodel.apply)(shard_params_replicated(params, mesh),
                                 jax.device_put(jnp.asarray(x),
                                                spatial_infer_sharding(mesh)))
    model = build(name, num_classes=2)
    DTypePolicy.parity().apply(model)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    state = model.state_dict()
    got = run_ranks(rank_forward, 4, name, state, {"num_classes": 2},
                    torch.from_numpy(x), 2, 2, threads=1)
    with torch.no_grad(), DTypePolicy.parity().precision():
        whole = model.to(memory_format=torch.channels_last)(
            torch.from_numpy(x))
    for key, tol in TOL.items():
        sharded = _join([g[key] for g in got]).numpy()
        np.testing.assert_allclose(sharded, np.asarray(want[key]),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(sharded, whole[key].numpy(), rtol=tol,
                                   atol=tol)


def test_spatial_serving_preset_matches_unsharded():
    """The e5m2 preset row-sharded: the stem tail reads its halo rows."""
    name = "googlenet_detectnet_serving"
    model = build(name, num_classes=2)
    model.init_weights(torch.Generator().manual_seed(0))
    policy = DTypePolicy(param_dtype=torch.bfloat16,
                         compute_dtype=torch.bfloat16)
    policy.apply(model)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 64, 48, 3)).astype(np.uint8))
    with torch.no_grad():
        whole = model.to(memory_format=torch.channels_last)(x)
    got = run_ranks(rank_forward, 4, name, model.state_dict(),
                    {"num_classes": 2}, x, 2, 2, "bf16", threads=1)
    for key in ("coverage", "bboxes"):
        sharded, want = _join([g[key] for g in got]), whole[key].float()
        scale = float(want.abs().max())
        assert float((sharded - want).abs().max()) <= 1e-5 * scale, key


@pytest.mark.parametrize("space", [2, 4])
def test_pool_kernels_plain_versions_on_halo_rows(space):
    """Each band with its halo rows (none past the frame) through the plain
    versions of the stem tail (e5m2 and bf16) and of LRN + pool: the bands'
    pooled rows joined are the unsharded result, bit for bit."""
    g = torch.Generator().manual_seed(space)
    h = 8 * space
    x = torch.rand((2, h, 12, 64), generator=g).bfloat16()
    wr, br = torch.randn((64, 64, 1, 1), generator=g) * 0.1, \
        torch.randn(64, generator=g) * 0.1
    w2, b2 = torch.randn((192, 64, 3, 3), generator=g) * 0.05, \
        torch.randn(192, generator=g) * 0.1
    rows = h // space
    for store in (None, torch.float8_e5m2):
        xs = x if store is None else x.to(store)
        want = stem_tail(xs, wr, br, w2, b2, store)
        parts = []
        for s in range(space):
            lo, hi = max(s * rows - 1, 0), min((s + 1) * rows + 2, h)
            parts.append(stem_tail(xs[:, lo:hi], wr, br, w2, b2, store,
                                   s * rows - lo, hi - (s + 1) * rows))
        assert torch.equal(torch.cat(parts, 1).float(), want.float())
    y = torch.rand((2, h, 12, 192), generator=g)
    parts = []
    for s in range(space):
        hi = min((s + 1) * rows + 1, h)
        parts.append(lrn_maxpool_cuda(y[:, s * rows:hi],
                                      halo_bottom=hi - (s + 1) * rows))
    assert torch.equal(torch.cat(parts, 1), lrn_maxpool_cuda(y))
    with pytest.raises(ValueError, match="even count"):
        check_inputs(x[:, :5].contiguous(), wr, br, w2, b2, None, 1, 1)
