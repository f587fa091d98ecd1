"""Weights of the port: ``.caffemodel`` files both ways against tpufcn's
converter, ``resolve_weights`` for each of its inputs, Trainer snapshots
(resume, retention, SIGTERM) and the serving surfaces' ``from_checkpoint``.
All on the CPU."""

import os
import signal
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.convert import convert_caffemodel as jax_convert
from tpufcn.convert import export_caffemodel as jax_export
from tpufcn.models import build as jax_build
from torchfcn.convert import (
    convert_caffemodel, export_caffemodel, resolve_weights, write_caffemodel)
from torchfcn.convert.from_jax import load_jax_params
from torchfcn.core.config import GridConfig, TrainConfig
from torchfcn.core.dtypes import DTypePolicy
from torchfcn.models import build
from torchfcn.serve.detector import Detector
from torchfcn.serve.profile import bias_heads
from torchfcn.serve.segment import Segmenter
from torchfcn.train.trainer import Trainer, load_snapshot_params

torch.set_num_threads(2)

# (model, frame size) of the conversion tests; ResNet-FPN's GroupNorms have
# no Caffe layer and keep their values
MODELS = [("googlenet_detectnet", 64), ("vgg_detectnet_train", 32),
          ("fcn8s_bbox", 64), ("resnet_fpn_detectnet", 64)]


def _jax_params(name, hw, seed=0):
    model = jax_build(name, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.key(seed),
                                 jnp.zeros((1, hw, hw, 3), jnp.float32))
    return jax.tree.map(np.asarray, params)


def _seeded(name, seed=1):
    model = build(name)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


@pytest.mark.parametrize("name,hw", MODELS)
def test_jax_caffemodel_loads_like_the_jax_tree(name, hw, tmp_path):
    """tpufcn.convert.export_caffemodel of a tpufcn tree, read by the
    port's convert_caffemodel, gives the tensors load_jax_params gives."""
    params = _jax_params(name, hw)
    path = str(tmp_path / "net.caffemodel")
    jax_export(params, path)
    want = _seeded(name)
    load_jax_params(want, params)
    got = _seeded(name)
    before = {k: v.clone() for k, v in got.state_dict().items()}
    convert_caffemodel(got, path, strict=True)
    for key, value in got.state_dict().items():
        if ".gn" in key or "_gn" in key:
            assert torch.equal(value, before[key]), key   # no Caffe layer
        else:
            assert torch.equal(value, want.state_dict()[key]), key


@pytest.mark.parametrize("name,hw", MODELS)
def test_port_caffemodel_reads_back_in_jax(name, hw, tmp_path):
    model = _seeded(name, seed=2)
    path = str(tmp_path / "net.caffemodel")
    export_caffemodel(model, path)
    init = _jax_params(name, hw, seed=3)
    got = jax_convert(init, path, strict=True)
    paths = model.flax_paths()
    for key, value in model.state_dict().items():
        node = got["params"]
        for part in paths[key]:
            node = node[part]
        want = value.numpy()
        if want.ndim == 4:
            want = want.transpose(2, 3, 1, 0)                # OIHW -> HWIO
        if ".gn" in key or "_gn" in key:
            continue
        np.testing.assert_array_equal(np.asarray(node), want, err_msg=key)


def test_bilinear_deconvs_are_skipped_and_strictness(tmp_path):
    model = _seeded("fcn32s_seg")
    k = np.outer([0.25, 0.75, 0.75, 0.25], [0.25, 0.75, 0.75, 0.25])
    layers = {"score_fr_6": [np.full((12, 512, 1, 1), 0.5, np.float32),
                             np.full((1, 12, 1, 1), 0.25, np.float32)],
              "upscore": [np.tile(k, (12, 1, 1, 1)).astype(np.float32)]}
    path = str(tmp_path / "a.caffemodel")
    write_caffemodel(path, layers)
    convert_caffemodel(model, path, strict=True)
    assert torch.all(model.score_fr_6.weight == 0.5)
    assert torch.all(model.score_fr_6.bias == 0.25)        # (1, C, 1, 1)
    layers["fc_extra"] = [np.ones((3, 4, 5, 5), np.float32)]
    write_caffemodel(path, layers)
    with pytest.raises(KeyError, match="fc_extra"):
        convert_caffemodel(model, path, strict=True)
    convert_caffemodel(model, path, strict=False)
    layers = {"conv5_3": [np.ones((3, 3, 3, 3), np.float32)]}
    write_caffemodel(path, layers)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert_caffemodel(model, path)


def _batch(rng, b=2, hw=32, classes=11, m=4):
    xy = rng.uniform(0, hw * 0.6, (b, m, 2))
    wh = rng.uniform(6, hw * 0.5, (b, m, 2))
    return {"image": rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8),
            "rects": np.concatenate([xy, wh], -1).astype(np.float32),
            "labels": rng.integers(0, classes, (b, m)).astype(np.int32),
            "valid": rng.random((b, m)) < 0.8}


def _trainer(snapdir, **kw):
    cfg = TrainConfig(grid=GridConfig(32, 32, 8, 11), snapshot_dir=snapdir,
                      log_every=100, **{"snapshot_every": 1, **kw})
    return Trainer(cfg, device="cpu", log_sink=lambda line: None)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [_batch(rng) for _ in range(n)]


def test_resolve_weights_each_input(tmp_path):
    seeded = _seeded("vgg_detectnet_train")
    model = _seeded("vgg_detectnet_train")
    assert resolve_weights(None, model) is model
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), seeded.state_dict().values()))
    other = _seeded("vgg_detectnet_train", seed=7)
    path = str(tmp_path / "w.caffemodel")
    export_caffemodel(other, path)
    resolve_weights(path, model)
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), other.state_dict().values()))
    trainer = _trainer(str(tmp_path / "snap"))
    state = trainer.fit(iter(_batches(1)), max_iter=1)
    resolve_weights(str(tmp_path / "snap"), model)
    for key, value in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key


def test_snapshot_resume_and_retention(tmp_path):
    """A resumed Trainer continues at the same step with the same
    parameters, optimizer state and generator, and its next step equals the
    uninterrupted run's; the last 5 snapshots are kept."""
    batches = _batches(8)
    full = _trainer(str(tmp_path / "full"), optimizer="adam").fit(
        iter(batches), max_iter=8)
    assert sorted(os.listdir(tmp_path / "full")) == [
        f"{s}.pt" for s in sorted(range(4, 9), key=str)]
    first = _trainer(str(tmp_path / "part"), optimizer="adam")
    first.fit(iter(batches[:6]), max_iter=6)
    again = _trainer(str(tmp_path / "part"), optimizer="adam")
    state = again.restore_latest(again.init_state())
    assert state.step == 6
    saved = torch.load(tmp_path / "part" / "6.pt", weights_only=True)
    opt = state.optimizer.state_dict()
    for pid, entry in saved["opt_state"]["state"].items():
        for key, value in entry.items():
            assert torch.equal(opt["state"][pid][key], value)
    state = again.fit(iter(batches[6:]), max_iter=8, state=state)
    assert state.step == 8
    for key, value in full.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[key], value), key


def test_sigterm_saves_and_stops(tmp_path):
    trainer = _trainer(str(tmp_path / "snap"), snapshot_every=0)
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are installed in the main thread only")

    def source():
        for i, batch in enumerate(_batches(5)):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    handler = signal.getsignal(signal.SIGTERM)
    state = trainer.fit(source(), max_iter=5)
    assert state.step == 3                     # the step in flight finished
    assert sorted(os.listdir(tmp_path / "snap")) == ["3.pt"]
    assert signal.getsignal(signal.SIGTERM) is handler


def test_from_checkpoint_serves_the_trained_parameters(tmp_path):
    trainer = _trainer(str(tmp_path / "snap"))
    state = trainer.fit(iter(_batches(2)), max_iter=2)
    step0 = _seeded("vgg_detectnet_train", seed=trainer.cfg.seed)
    frames = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3),
                                                dtype=np.uint8)
    det = Detector.from_checkpoint(str(tmp_path / "snap"),
                                   "vgg_detectnet_train", device="cpu",
                                   max_candidates=16)
    mem = Detector("vgg_detectnet_train", device="cpu", max_candidates=16)
    mem.model.load_state_dict(state.model.state_dict())
    for name, value in det.model.state_dict().items():
        assert torch.equal(value, mem.model.state_dict()[name]), name
    for name, p in step0.named_parameters():
        assert not torch.equal(state.model.state_dict()[name], p), name
    for d in (det, mem):
        bias_heads(d)
    got = det(frames)
    assert int(got.valid.sum()) > 0
    for a, b in zip(got, mem(frames)):
        assert torch.equal(a, b)
    params = load_snapshot_params(str(tmp_path / "snap"), step=1)
    assert set(params) == set(state.model.state_dict())
    # a snapshot of the exact net loads into its e5m2 serving preset
    seg_dir = tmp_path / "seg"
    seg = Segmenter("fcn32s_seg", device="cpu", policy=DTypePolicy.parity())
    seg_state = {k: v + 0.01 for k, v in seg.model.state_dict().items()}
    os.makedirs(seg_dir)
    torch.save({"step": 3, "params": seg_state}, seg_dir / "3.pt")
    served = Segmenter.from_checkpoint(str(seg_dir), "fcn32s_seg_serving",
                                       device="cpu")
    for key, value in served.model.state_dict().items():
        assert torch.equal(value, seg_state[key].to(value.dtype)), key
