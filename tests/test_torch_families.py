"""torchfcn's VGG, FCN and ResNet-FPN families against tpufcn's in float32
on the same weights, carried across by the strict weight bridge; and the
port's registry against tpufcn's.

Each family's JAX model is initialised (Flax's init) and applied once per
module at a small size (the pyramid net at 448x448, B = 1: its pyramid only
closes there).  The demean families get the same demeaned frames on both
sides.  Tolerance: every head within 1e-5 of its largest magnitude
(measured at most 3e-6: float32 convolutions summing in other orders)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.models import build as jax_build
from tpufcn.models import names as jax_names
from tpufcn.ops.image import demean_bgr as jax_demean
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.models import build, get_spec, names
from torchfcn.models.layers import GroupNorm

torch.set_num_threads(2)

# model, frame size, batch
FAMILIES = {
    "vgg_detectnet_train": (64, 2),
    "fcn8s_bbox": (96, 1),
    "fcn32s_seg": (64, 2),
    "resnet_fpn_detectnet": (64, 2),
    "vgg_pyramid_detectnet": (448, 1),
}
_CACHE = {}


def reference(name):
    """(JAX params as numpy, model input, JAX float32 outputs) of ``name``,
    computed once per module."""
    if name not in _CACHE:
        hw, batch = FAMILIES[name]
        model = jax_build(name, dtype=jnp.float32)
        params = jax.jit(model.init)(
            jax.random.key(0), jnp.zeros((1, hw, hw, 3), jnp.float32))
        params = jax.tree.map(np.array, params)
        frames = np.random.default_rng(1).integers(
            0, 256, (batch, hw, hw, 3)).astype(np.float32)
        x = frames if get_spec(name).preprocessing == "shift127" \
            else np.array(jax_demean(frames))
        out = jax.jit(model.apply)(params, x)
        _CACHE[name] = params, x, {k: np.asarray(v) for k, v in out.items()}
    return _CACHE[name]


def test_registry_names_match_jax():
    assert names() == sorted(jax_names())
    for name in names():
        spec = get_spec(name)
        assert set(spec.heads) <= {"coverage", "bboxes", "seg"}
        assert spec.preprocessing in ("shift127", "demean")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_f32_forward_matches_jax(name):
    params, x, want = reference(name)
    model = build(name).to(memory_format=torch.channels_last)
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == sorted(
        set(get_spec(name).heads) | ({"score"} if "score" in want else set()))
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == torch.float32, key
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=1e-5 * scale, err_msg=key)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _edit(tree, path, value=None):
    """A copy of ``tree`` with the leaf at ``path`` set, or removed if
    ``value`` is None."""
    out = {k: v for k, v in tree.items()}
    if len(path) == 1:
        if value is None:
            del out[path[0]]
        else:
            out[path[0]] = value
    else:
        out[path[0]] = _edit(tree[path[0]], path[1:], value)
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_weight_bridge_is_strict(name):
    """Every leaf is used once and every parameter set; a missing leaf, an
    unused leaf or a wrong shape raises."""
    params, _, _ = reference(name)
    model = build(name)
    leaves = dict(_leaves(params["params"]))
    paths = model.flax_paths()
    assert sorted(paths) == sorted(n for n, _ in model.named_parameters())
    assert sorted(paths.values()) == sorted(leaves)
    load_jax_params(model, params)
    for pname, p in model.named_parameters():
        v = leaves[paths[pname]]
        want = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        assert np.array_equal(p.detach().numpy(), want), pname

    path = sorted(leaves)[len(leaves) // 2]
    with pytest.raises(KeyError, match="/".join(path)):
        load_jax_params(model, {"params": _edit(params["params"], path)})
    extra = _edit(params["params"], path[:-1] + ("extra",), np.ones(3))
    with pytest.raises(KeyError, match="not loaded"):
        load_jax_params(model, {"params": extra})
    kernel = next(p for p in sorted(leaves) if p[-1] == "kernel")
    wrong = _edit(params["params"], kernel,
                  np.zeros(leaves[kernel].shape[:-1] + (7,), np.float32))
    with pytest.raises(ValueError, match="JAX shape"):
        load_jax_params(model, {"params": wrong})


def test_flax_paths_of_each_family():
    """Caffe names with a slash, GroupNorm scale, Flax's bias-free convs."""
    vgg = build("vgg_pyramid_detectnet").flax_paths()
    assert vgg["backbone.conv4_3.weight"] == (
        "backbone", "conv4_3", "conv", "kernel")
    assert vgg["pyramid7.bias"] == ("conv4_3/7x7", "conv", "bias")
    assert vgg["cvg.weight"] == ("cvg/classifier", "conv", "kernel")
    assert build("fcn32s_seg").flax_paths()["score_fr_6.weight"] == (
        "score_fr_6", "conv", "kernel")
    res = build("resnet_fpn_detectnet").flax_paths()
    assert res["stage2_block0.down.weight"] == (
        "stage2_block0", "down", "kernel")
    assert res["stage2_block0.gn_down.weight"] == (
        "stage2_block0", "gn_down", "scale")
    assert res["stem_conv.weight"] == ("stem_conv", "kernel")
    assert res["lat5.bias"] == ("lat5", "conv", "bias")
    assert "stage1_block0.down.weight" not in res      # identity shortcut


def test_build_overrides_and_group_norm_dtype():
    """``build`` passes num_classes and store_dtype to the constructor; a
    bf16 cast keeps the GroupNorm parameters float32, as Flax does."""
    model = build("resnet_fpn_detectnet", num_classes=2,
                  store_dtype=torch.float8_e5m2)
    assert model.cvg.out_channels == 2 and model.bbox.out_channels == 8
    assert model.store_dtype == torch.float8_e5m2
    assert build("fcn8s_bbox_serving").backbone.store_stages == 2
    assert build("fcn8s_bbox_serving", store_stages=5).backbone \
        .store_stages == 5
    model = model.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    norms = [m for m in model.modules() if isinstance(m, GroupNorm)]
    assert norms and all(m.weight.dtype == m.bias.dtype == torch.float32
                         for m in norms)
    assert model.stem_conv.weight.dtype == torch.bfloat16
    out = model(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
    assert out["coverage"].shape == (1, 4, 4, 2)
    with pytest.raises(ValueError, match="float8_e5m2"):
        build("vgg_detectnet_train", store_dtype=torch.float8_e4m3fn)
