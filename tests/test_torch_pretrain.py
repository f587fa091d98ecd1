"""The port's VGG16 backbone pretrain (``torchfcn/train/pretrain.py``)
against tpufcn's.

* ``render_cls_dataset``: the same labels and draws as tpufcn's bank for
  the same seed; images equal but at the values stated (the colour field's
  cubic upscale within 1, ellipse boundary pixels);
* the classifier's float32 forward on tpufcn's parameters carried by
  ``load_jax_params``: logits within 1e-4 of their scale (the convolutions
  sum in other orders);
* a 2-step ``pretrain_vgg16`` exports a ``.caffemodel`` that loads by name
  into the port's and tpufcn's VGG detection nets: every backbone conv
  equals the classifier's bit for bit, the heads keep their init; and
  tpufcn's export loads into the port's net the same way;
* ``cached_vgg16_pretrain`` reuses its file per configuration, under
  tpufcn's cache names.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.train import pretrain as J
from torchfcn.convert import load_caffemodel, resolve_weights
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.models import build
from torchfcn.ops.image import demean_bgr
from torchfcn.train import pretrain as P

torch.set_num_threads(2)

LOGIT_RTOL = 1e-4


def test_render_cls_dataset_matches_jax():
    got, got_l = P.render_cls_dataset(classes=4, n=64, size=32, seed=3)
    want, want_l = J.render_cls_dataset(classes=4, n=64, size=32, seed=3)
    assert got.shape == (64, 32, 32, 3) and got.dtype == np.uint8
    assert got_l.dtype == np.int32 and np.array_equal(got_l, want_l)
    assert set(np.unique(got_l)) <= set(range(6)) and got_l.max() >= 4
    d = np.abs(got.astype(int) - want)
    # 196,608 values: 3 differ on this cv2 build (ellipse boundary pixels
    # and the cubic upscale); the bound leaves room for IPP's other CPU
    # paths
    assert int((d > 0).sum()) <= 30, int((d > 0).sum())
    again, _ = P.render_cls_dataset(classes=4, n=64, size=32, seed=3)
    assert np.array_equal(again, got)


def test_classifier_forward_matches_jax():
    size, n_cls = 32, 6
    jmodel = J._build_classifier(n_cls, jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, size, size, 3), jnp.float32)))
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (3, size, size, 3)).astype(np.uint8)
    x = demean_bgr(torch.from_numpy(frames))
    want = np.asarray(jmodel.apply(params, jnp.asarray(x.numpy())))
    model = P.VGG16Classifier(n_cls)
    DTypePolicy.parity().apply(model)
    load_jax_params(model, params)
    with torch.no_grad():
        got = model.eval()(x).numpy()
    assert got.shape == want.shape == (3, n_cls)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


def _backbone_blobs(path):
    return {k: v for k, v in load_caffemodel(path).items()
            if k.startswith("backbone/")}


def test_pretrain_export_loads_by_name_on_both_sides(tmp_path):
    from tpufcn.convert import resolve_weights as jax_resolve
    from tpufcn.models import build as jax_build

    out = str(tmp_path / "vgg16.caffemodel")
    lines = []
    res = P.pretrain_vgg16(out, classes=2, steps=2, batch=4, size=32,
                           n_bank=16, log=lines.append, device="cpu")
    assert res["path"] == out and res["steps"] == 2
    # logged at step 1 and at the last step, with the losses it returns
    steps = [m for m in lines if m.startswith("pretrain: step ")]
    assert [m.split()[2] for m in steps] == ["1/2", "2/2"]
    assert f"loss {res['loss_start']:.4f}" in steps[0]
    assert f"loss {res['loss']:.4f}" in steps[1]
    assert set(res) == {"loss", "train_acc", "steps", "path", "loss_start"}
    blobs = _backbone_blobs(out)
    assert len(blobs) == 13 and "fc_cls" in load_caffemodel(out)
    # the port's net: every backbone conv bit-equal, the heads untouched
    net = build("vgg_pyramid_detectnet", num_classes=3)
    net.init_weights(torch.Generator().manual_seed(0))
    head = net.cvg.weight.clone()
    resolve_weights(out, net)
    for name, (w, b) in blobs.items():
        conv = getattr(net.backbone, name.split("/")[1])
        assert np.array_equal(conv.weight.detach().numpy(), w)
        assert np.array_equal(conv.bias.detach().numpy(), b)
    assert torch.equal(net.cvg.weight, head)
    # tpufcn's net reads the same blobs
    jnet = jax_build("vgg_detectnet_train", dtype=jnp.float32, num_classes=3)
    init = jax.jit(jnet.init)(jax.random.key(0),
                              jnp.zeros((1, 32, 32, 3), jnp.float32))
    seeded = jax_resolve(out, lambda: init)
    k = np.asarray(seeded["params"]["backbone"]["conv1_1"]["conv"]["kernel"])
    assert np.array_equal(k.transpose(3, 2, 0, 1),
                          blobs["backbone/conv1_1"][0])
    # and tpufcn's export loads into the port's net by the same names
    jout = str(tmp_path / "jax.caffemodel")
    J.pretrain_vgg16(jout, classes=2, steps=1, batch=4, size=32, n_bank=16,
                     steps_per_dispatch=1)
    jblobs = _backbone_blobs(jout)
    assert set(jblobs) == set(blobs)
    resolve_weights(jout, net)
    assert np.array_equal(net.backbone.conv5_3.weight.detach().numpy(),
                          jblobs["backbone/conv5_3"][0])


def test_cached_pretrain_reuses_file(tmp_path, monkeypatch):
    calls = []

    def fake_pretrain(path, **kw):
        calls.append(path)
        open(path, "wb").write(b"x")
        return {"path": path}

    monkeypatch.setattr(P, "pretrain_vgg16", fake_pretrain)
    p1 = P.cached_vgg16_pretrain(str(tmp_path), steps=10, device="cpu")
    p2 = P.cached_vgg16_pretrain(str(tmp_path), steps=10, device="cpu")
    assert p1 == p2 and len(calls) == 1
    p3 = P.cached_vgg16_pretrain(str(tmp_path), steps=20, device="cpu")
    assert p3 != p1 and len(calls) == 2
    for kw in ({}, dict(classes=6, steps=4000, size=128, n_bank=8192,
                        lr=1e-4, seed=0)):
        assert P.pretrain_cache_path("r", **kw) == \
            J.pretrain_cache_path("r", **kw)


def test_pretrain_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.pretrain_vgg16("unused.caffemodel", steps=1)
