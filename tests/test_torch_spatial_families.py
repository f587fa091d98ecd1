"""Row sharding of the FCN, pyramid, ResNet-FPN and GoogLeNet families on
gloo CPU ranks against tpufcn's ``spatial_infer_sharding`` forward (GSPMD
on ``tests/conftest.py``'s virtual CPU devices) on the same weights,
float32: FCN-8s, FCN-32s, the VGG pyramid (448x448, B = 1, where its
pyramid closes), ResNet-FPN and GoogLeNet, the port's bands uneven where
the case says (``core.mesh.row_bands``; tpufcn's input shards are even,
and its GSPMD pads the layers whose rows do not split).  Bounds as
``tests/test_torch_spatial.py``'s: coverage within 1e-5 and bboxes within
1e-4, rtol and atol; ``seg`` and ``score`` within 1e-4 of their largest
magnitude."""

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
from torchfcn.models import build, get_spec
from torchfcn.parallel.distributed import run_ranks

from test_torch_mesh_ranks import rank_forward

torch.set_num_threads(2)

TOL = {"coverage": 1e-5, "bboxes": 1e-4}
SCALED = 1e-4              # seg and score, of their largest magnitude


def _join(parts, data, space):
    """The ranks' (batch shard, row band) outputs as the global tensor."""
    return torch.cat([torch.cat(parts[d * space:(d + 1) * space], dim=1)
                      for d in range(data)], dim=0)


def _frames(name, batch, h, w, seed=0):
    rng = np.random.default_rng(seed)
    scale = 255.0 if get_spec(name).preprocessing == "shift127" else 1.0
    return rng.random((batch, h, w, 3), dtype=np.float32) * scale


# name, batch, rows, columns, data, space
CASES = [
    ("fcn8s_bbox", 2, 96, 64, 1, 2),        # bands 64 + 32: 2 + 1 pool5
    ("fcn32s_seg", 2, 64, 64, 2, 2),
    ("vgg_pyramid_detectnet", 1, 448, 448, 1, 2),
    ("resnet_fpn_detectnet", 2, 96, 64, 1, 2),    # 64 + 32: C5 2 + 1
    ("googlenet_detectnet", 1, 144, 64, 1, 3),    # 64 + 32 + 48
]


@pytest.mark.parametrize("name,batch,h,w,data,space", CASES)
def test_row_sharded_family_matches_tpufcn(name, batch, h, w, data, space):
    x = _frames(name, batch, h, w)
    jmodel = jax_build(name, dtype=jnp.float32, num_classes=3)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x))
    mesh = jmake_mesh(JMeshConfig(data=data, space=space),
                      devices=jax.devices("cpu")[:data * space])
    want = jax.jit(jmodel.apply)(shard_params_replicated(params, mesh),
                                 jax.device_put(jnp.asarray(x),
                                                spatial_infer_sharding(mesh)))
    model = build(name, num_classes=3)
    DTypePolicy.parity().apply(model)
    load_jax_params(model, jax.tree.map(np.asarray, params))
    got = run_ranks(rank_forward, data * space, name, model.state_dict(),
                    {"num_classes": 3}, torch.from_numpy(x), data, space,
                    threads=1)
    assert sorted(got[0]) == sorted(want)
    for key in want:
        sharded = _join([g[key] for g in got], data, space).numpy()
        ref = np.asarray(want[key])
        assert sharded.shape == ref.shape, key
        if key in TOL:
            np.testing.assert_allclose(sharded, ref, rtol=TOL[key],
                                       atol=TOL[key], err_msg=key)
        else:
            np.testing.assert_allclose(sharded, ref, rtol=0,
                                       atol=SCALED * np.abs(ref).max(),
                                       err_msg=key)
