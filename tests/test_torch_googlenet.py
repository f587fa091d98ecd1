"""torchfcn's GoogLeNet DetectNet against tpufcn's on the same weights.

The JAX model is initialised and applied once per module (about 13 s on a
CPU); its parameters go through the strict weight bridge into the port."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.models import build as jax_build
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.models import build
from torchfcn.models.layers import CaffeConv

torch.set_num_threads(2)

HW, BATCH = 128, 2


@pytest.fixture(scope="module")
def reference():
    """JAX params (numpy tree), frames and f32 outputs at 128x128."""
    model = jax_build("googlenet_detectnet", dtype=jnp.float32)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    frames = np.random.default_rng(1).integers(
        0, 256, (BATCH, HW, HW, 3)).astype(np.uint8)
    out = jax.jit(model.apply)(params, jnp.asarray(frames, jnp.float32))
    return params, frames, {k: np.asarray(v) for k, v in out.items()}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def test_weight_bridge_is_strict(reference):
    params, _, _ = reference
    model = build("googlenet_detectnet")
    leaves = dict(_leaves(params["params"]))
    paths = model.flax_paths()
    # one JAX leaf per port parameter, and no two parameters share one
    assert sorted(paths) == sorted(n for n, _ in model.named_parameters())
    assert sorted(paths.values()) == sorted(leaves)
    load_jax_params(model, params)
    for name, p in model.named_parameters():
        v = leaves[paths[name]]
        want = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        assert np.array_equal(p.detach().numpy(), want), name

    extra = _copy(params)
    extra["params"]["inception_3a"]["1x1"]["conv"]["scale"] = np.ones(64)
    with pytest.raises(KeyError, match="not loaded"):
        load_jax_params(model, extra)
    missing = _copy(params)
    del missing["params"]["cvg/classifier"]["conv"]["bias"]
    with pytest.raises(KeyError, match="cvg/classifier"):
        load_jax_params(model, missing)
    wrong = _copy(params)
    wrong["params"]["conv2/3x3"]["conv"]["kernel"] = np.zeros((3, 3, 64, 7))
    with pytest.raises(ValueError, match="conv2"):
        load_jax_params(model, wrong)


def test_jax_path_names():
    paths = build("googlenet_detectnet").flax_paths()
    assert paths["conv1.weight"] == ("conv1/7x7_s2", "conv", "kernel")
    assert paths["inception_4e.b5x5_reduce.bias"] == (
        "inception_4e", "5x5_reduce", "conv", "bias")
    assert paths["bbox.weight"] == ("bbox/regressor", "conv", "kernel")


def test_f32_forward_matches_jax(reference):
    params, frames, want = reference
    model = build("googlenet_detectnet").to(memory_format=torch.channels_last)
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    for key in ("coverage", "bboxes"):
        assert got[key].shape == want[key].shape
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4,
                                   rtol=0, err_msg=key)


def test_seeded_init_uses_only_its_generator():
    state = torch.random.get_rng_state()
    a, b = build("googlenet_detectnet_1cls"), build("googlenet_detectnet_1cls")
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    for m in a.modules():
        if isinstance(m, CaffeConv):
            bound = (3.0 / m.weight[0].numel()) ** 0.5
            assert m.weight.abs().max() <= bound and not m.bias.any()


def test_bf16_forward_shapes(reference):
    _, frames, want = reference
    model = build("googlenet_detectnet_3cls").to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(torch.from_numpy(frames))
    assert got["coverage"].shape == (BATCH, HW // 16, HW // 16, 3)
    assert got["bboxes"].shape == (BATCH, HW // 16, HW // 16, 12)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in got.values())
