"""The port's (data, space) mesh against tpufcn's: the same layout of
ranks (rank r of the port sits where device r sits in tpufcn's mesh over
``tests/conftest.py``'s 8 virtual CPU devices), the same groups, and the
same errors for a mesh larger than the world and for a global batch that
the data axis does not divide.  Each mesh runs on gloo CPU ranks."""

import numpy as np
import jax
import pytest

from tpufcn.core.config import MeshConfig as JMeshConfig
from tpufcn.core import mesh as jmesh
from torchfcn.core import mesh as tmesh
from torchfcn.core.config import MeshConfig
from torchfcn.parallel.distributed import run_ranks

from test_torch_mesh_ranks import rank_layout


@pytest.mark.parametrize("data,space", [(2, 1), (1, 2), (2, 2)])
def test_mesh_layout_and_errors_match_tpufcn(data, space):
    n = data * space
    devices = jax.devices("cpu")[:n]
    jm = jmesh.make_mesh(JMeshConfig(data, space), devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(jm.devices)
    got = run_ranks(rank_layout, n, data, space, threads=1)
    for rank, d, s, data_peers, space_peers, errors, local in got:
        assert ids[d, s] == rank
        assert data_peers == [int(v) for v in ids[:, s]]
        assert space_peers == [int(v) for v in ids[d, :]]
        # tpufcn's messages, with the port's world in place of its devices
        with pytest.raises(ValueError) as big:
            jmesh.make_mesh(JMeshConfig(2 * data, 2 * space),
                            devices=devices)
        assert errors[0] == str(big.value)
        if data > 1:        # every batch divides over one data shard
            with pytest.raises(ValueError) as uneven:
                jmesh.local_batch(2 * data + 1, jm)
            assert errors[1:] == [str(uneven.value)]
        else:
            assert len(errors) == 1
        assert local == jmesh.local_batch(4 * data, jm)
    assert jmesh.DATA_AXIS == tmesh.DATA_AXIS
    assert jmesh.SPACE_AXIS == tmesh.SPACE_AXIS


def test_mesh_config_and_row_constraint():
    """The port's MeshConfig is tpufcn's copy; row sharding splits rows
    that do not divide by space x stride into uneven bands (440 rows: 224
    + 216) and refuses only a frame with fewer stride-rows than ranks,
    naming the constraint."""
    for cfg in (MeshConfig(), MeshConfig(4, 2)):
        assert cfg.num_devices == JMeshConfig(cfg.data,
                                              cfg.space).num_devices
    mesh = tmesh.Mesh(1, 2, 0, {"mesh": None, "data": None, "space": None},
                      "cpu")
    assert tmesh.space_sharded(mesh) and not tmesh.space_sharded(None)
    assert mesh.band(448) == (0, 224)
    assert tmesh.row_bands(440, 2) == ((0, 224), (224, 216))
    with pytest.raises(ValueError, match="at least 2 units of 32 rows"):
        mesh.band(32)
    assert mesh.first_row_shard and not mesh.last_row_shard
    assert mesh.shape == {"data": 1, "space": 2}
