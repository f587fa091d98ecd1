"""torchfcn's e5m2 serving presets of the VGG and FCN families, and the
ResNet-FPN with e5m2 block storage, against tpufcn's on the same weights
(bf16 compute, e5m2 storage).

The two frameworks sum float32 convolutions in other orders, and XLA on
the CPU skips some bf16 roundings that the JAX code writes (its default
excess precision), so now and then an activation rounds the other way.  An
e5m2 value that rounds the other way moves by a quarter, and the layers
after it spread that: the share of bit-equal head entries falls with the
depth of the chain after the first flip.  Each head is held to a share of
bit-equal entries and a largest |difference|, with the measured values
(same seeds, 2 threads) beside the bounds:

  preset                          head      bit-equal        max |diff|
  vgg_pyramid_detectnet_serving   coverage  >= 60 % (73.8)   2e-3 of 0.51
  (448x448, B = 1)                bboxes    >= 60 % (70.7)   1.0e-2 of 0.080
  fcn8s_bbox_serving (96x96)      bboxes    >= 10 % (14.3)   1.2e-4 of 0.033
                                  seg       >= 2.5 % (3.4)   1.4e-3 of 0.18
                                  coverage  -- (softmax of every score)
  fcn32s_seg_serving (64x64)      seg       >= 40 % (50.1)   3.0e-3 of 0.022
                                  score     >= 30 % (38.8)   2.6e-4 of 0.085

and the bounds on max |diff| are twice the measured ones.  fcn8s's
coverage is a softmax over all classes, so one score that differs moves
every probability of its cell: it is held to its max |diff| only.

ResNet-FPN with ``store_dtype`` e5m2 stores every block output: its first
stored block output is held to a share of bit-equal entries (85.3 %
measured at 128x128), and its heads, after eight such blocks, to lie no
further from tpufcn's than the e5m2 storage itself moves the port's heads
(measured 0.92 and 0.96 of that).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.models import build as jax_build
from tpufcn.models.vgg import VGG16Backbone as JaxBackbone
from tpufcn.ops.image import demean_bgr as jax_demean
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.models import build
from torchfcn.models.layers import ZooModel, nhwc
from torchfcn.models.vgg import VGG16Backbone

torch.set_num_threads(2)

E5M2 = torch.float8_e5m2
# preset: frame size, batch, {head: (least bit-equal share, max |diff|)}
PRESETS = {
    "vgg_pyramid_detectnet_serving": (448, 1, {
        "coverage": (0.60, 4e-3), "bboxes": (0.60, 2e-2)}),
    "fcn8s_bbox_serving": (96, 2, {
        "bboxes": (0.10, 2.4e-4), "seg": (0.025, 2.8e-3),
        "coverage": (0.0, 2.9e-4)}),
    "fcn32s_seg_serving": (64, 2, {
        "seg": (0.40, 6e-3), "score": (0.30, 5.2e-4)}),
}


def _jax_reference(name, hw, batch, **kwargs):
    """JAX params (numpy), the model's input and its bf16 outputs."""
    model = jax_build(name, dtype=jnp.bfloat16, **kwargs)
    params = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, hw, hw, 3), jnp.float32)))
    frames = np.random.default_rng(1).integers(
        0, 256, (batch, hw, hw, 3)).astype(np.float32)
    x = frames if name.startswith("resnet") else np.array(jax_demean(frames))
    return model, params, x


def _port(name, params, **kwargs):
    model = build(name, **kwargs).to(dtype=torch.bfloat16,
                                     memory_format=torch.channels_last)
    load_jax_params(model, params)
    return model


@pytest.mark.parametrize("name", list(PRESETS))
def test_serving_preset_matches_jax(name):
    hw, batch, bounds = PRESETS[name]
    model, params, x = _jax_reference(name, hw, batch)
    want = {k: np.asarray(v, np.float32)
            for k, v in jax.jit(model.apply)(params, x).items()}
    with torch.no_grad():
        got = _port(name, params)(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == sorted(bounds)
    for key, (share, atol) in bounds.items():
        g = got[key].numpy()
        assert g.dtype == np.float32 and g.shape == want[key].shape, key
        assert (g == want[key]).mean() >= share, key
        np.testing.assert_allclose(g, want[key], rtol=0, atol=atol,
                                   err_msg=key)


def test_fcn8s_serving_keeps_head_taps_in_bf16():
    """fcn8s_bbox_serving stores stages 1-2 only: the taps its score heads
    read (pool3, pool4, conv5_3) stay in the compute dtype, as
    tests/test_models.py holds tpufcn's."""
    bb = build("fcn8s_bbox_serving").backbone.to(torch.bfloat16)
    taps = bb(torch.zeros(1, 3, 64, 64, dtype=torch.bfloat16))
    assert taps["pool1"].dtype == taps["pool2"].dtype == E5M2
    for tap in ("pool3", "pool4", "conv5_3"):
        assert taps[tap].dtype == torch.bfloat16, tap
    full = build("fcn32s_seg_serving").backbone.to(torch.bfloat16)
    assert full(torch.zeros(1, 3, 32, 32, dtype=torch.bfloat16))[
        "conv5_3"].dtype == E5M2


class _Backbone(ZooModel):
    """The VGG16 backbone alone, under the name the JAX models give it."""

    def __init__(self):
        super().__init__()
        self.backbone = VGG16Backbone(store_dtype=E5M2)


def test_backbone_storage_matches_jax():
    """The VGG16 backbone with every stage stored in e5m2, alone: its taps
    against tpufcn's at 64x64 (measured: all equal but one conv2_2 entry
    of 131,072)."""
    x = np.array(jax_demean(np.random.default_rng(1).integers(
        0, 256, (2, 64, 64, 3)).astype(np.float32)))
    jb = JaxBackbone(dtype=jnp.bfloat16, store_dtype=jnp.float8_e5m2)
    params = jax.tree.map(np.array, jb.init(jax.random.key(0), x))
    want = jb.apply(params, x)
    model = _Backbone()
    load_jax_params(model, {"params": {"backbone": params["params"]}})
    model = model.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    with torch.no_grad():
        taps = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("pool1", "pool2", "pool3", "pool4", "conv4_3", "conv5_3"):
        assert taps[key].dtype == E5M2, key
        g = nhwc(taps[key]).float().numpy()
        w = np.asarray(want[key].astype(jnp.float32))
        assert (g == w).mean() >= 0.999, key


def test_resnet_e5m2_storage_against_jax():
    hw = 128
    model, params, x = _jax_reference("resnet_fpn_detectnet", hw, 2,
                                      store_dtype=jnp.float8_e5m2)
    want, inter = jax.jit(lambda p, v: model.apply(
        p, v, capture_intermediates=True))(params, x)
    port = _port("resnet_fpn_detectnet", params, store_dtype=E5M2)
    exact = _port("resnet_fpn_detectnet", params)
    blocks = []
    port.stage1_block0.register_forward_hook(
        lambda module, args, out: blocks.append(out))
    with torch.no_grad():
        got, plain = port(torch.from_numpy(x)), exact(torch.from_numpy(x))
    first = np.asarray(inter["intermediates"]["stage1_block0"]["__call__"][0]
                       .astype(jnp.float32))
    assert blocks[0].dtype == E5M2
    assert (nhwc(blocks[0]).float().numpy() == first).mean() >= 0.8
    for key in ("coverage", "bboxes"):
        g = got[key].numpy()
        assert np.isfinite(g).all()
        to_jax = np.abs(g - np.asarray(want[key], np.float32)).mean()
        storage = np.abs(g - plain[key].numpy()).mean()
        assert 0 < to_jax <= 1.1 * storage, key
