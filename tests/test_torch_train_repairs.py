"""The port's precision policy, its kernels as custom ops, and dropout.

* ``torch.library.opcheck`` on the four custom ops (their CPU and fake
  implementations, and the registered backward of the two LRN ops), and
  the LRN ops' gradients equal to autograd through the plain versions;
* the stem tail refuses inputs that need a gradient, and the Trainer
  refuses the e5m2 serving preset;
* ``DTypePolicy.parity()`` turns TF32 off inside its scope and gives the
  caller's settings back;
* a model with float32 parameters computing in bf16 gives the same outputs,
  bit for bit, as the model cast to bf16 (the serving default);
* dropout acts in train mode only, from the generator the step passes.
"""

import numpy as np
import pytest
import torch

from torchfcn.core.config import MeshConfig, TrainConfig
from torchfcn.core.dtypes import DTypePolicy, float32_exact
from torchfcn.core.mesh import Mesh
from torchfcn.models import build
from torchfcn.models.layers import dropout
from torchfcn.ops.caffe_layers import lrn_across_channels
from torchfcn.ops.cuda.group_rects import group_rects_op
from torchfcn.ops.cuda.lrn import lrn_cuda, lrn_op
from torchfcn.ops.cuda.lrn_pool import lrn_maxpool, lrn_maxpool_cuda, \
    lrn_maxpool_op
from torchfcn.ops.cuda.stem import stem_tail_cuda, stem_tail_op
from torchfcn.train.trainer import Trainer

torch.set_num_threads(2)


def _x(shape, dtype=torch.float32, seed=0, grad=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32) * 30)
    return x.to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_lrn_ops(dtype):
    for grad in (False, True):
        torch.library.opcheck(lrn_op, (_x((2, 5, 7, 13), dtype, grad=grad),
                                       5, 1e-4, 1.0))
        torch.library.opcheck(lrn_maxpool_op,
                              (_x((2, 9, 8, 16), dtype, grad=grad), 5, 1e-4))


def test_opcheck_stem_tail_and_group_rects():
    rng = np.random.default_rng(1)
    x = _x((1, 7, 9, 64)).abs().to(torch.bfloat16)
    weights = [torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
               .to(torch.bfloat16) for s, shape in (
                   (0.1, (64, 64, 1, 1)), (0.1, (64,)),
                   (0.05, (192, 64, 3, 3)), (0.1, (192,)))]
    torch.library.opcheck(stem_tail_op, (x, *weights, None))
    # the schema check multiplies the outputs, which e5m2 does not take on
    # the CPU: the fake implementation against the real one
    torch.library.opcheck(stem_tail_op,
                          (x.to(torch.float8_e5m2), *weights,
                           torch.float8_e5m2),
                          test_utils=("test_faketensor",))
    rects = torch.from_numpy(rng.uniform(0, 60, (3, 40, 4)).astype(np.float32))
    rects[:, :20] = rects[:, :1] + torch.from_numpy(
        rng.normal(0, 1, (3, 20, 4)).astype(np.float32))
    valid = torch.from_numpy(rng.random((3, 40)) < 0.8)
    torch.library.opcheck(group_rects_op, (rects, valid, 3, 0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lrn_op_gradients_equal_plain_autograd(dtype):
    """On the CPU the op's backward is the plain version's vector-Jacobian
    product, bit for bit (on the card the same formula runs on the same
    input; chip_smoke.py holds it there)."""
    cases = ((lrn_cuda, lambda t: lrn_across_channels(t), (2, 6, 5, 67)),
             (lrn_maxpool_cuda, lambda t: lrn_maxpool(t), (2, 11, 9, 64)))
    for op, plain, shape in cases:
        x = _x(shape, dtype, seed=2, grad=True)
        g = _x(op(x.detach()).shape, dtype, seed=3)
        got, = torch.autograd.grad(op(x), x, g)
        want, = torch.autograd.grad(plain(x), x, g)
        assert got.dtype == dtype
        assert torch.equal(got, want)


def test_stem_tail_raises_under_grad():
    rng = np.random.default_rng(4)
    x = _x((1, 5, 5, 64)).abs().to(torch.bfloat16)
    w = [torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
         .to(torch.bfloat16) for s in ((64, 64, 1, 1), (64,), (192, 64, 3, 3),
                                       (192,))]
    stem_tail_cuda(x, *w)                                # no grad: runs
    w[2].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        stem_tail_cuda(x, *w)
    with torch.no_grad():
        stem_tail_cuda(x, *w)


def test_trainer_refuses_the_e5m2_serving_preset():
    cfg = TrainConfig(model="googlenet_detectnet_serving")
    with pytest.raises(ValueError, match="serving-only"):
        Trainer(cfg, device="cpu")
    # a mesh is no longer refused: the Trainer runs on the mesh's device,
    # and a cfg.mesh of several devices needs the process group first
    mesh = Mesh(1, 1, 0, {"mesh": None, "data": None, "space": None}, "cpu")
    trainer = Trainer(TrainConfig(model="googlenet_detectnet"), mesh=mesh,
                      device="cuda")
    assert trainer.mesh is mesh and trainer.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        Trainer(TrainConfig(model="googlenet_detectnet",
                            mesh=MeshConfig(data=2)), device="cpu")


def _tf32():
    b = torch.backends
    return b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision


def test_parity_scope_restores_the_callers_tf32_flags():
    b = torch.backends
    saved = _tf32()
    try:
        # a caller who allowed TF32 through the legacy flags
        b.cudnn.allow_tf32 = True
        b.cuda.matmul.allow_tf32 = True
        with DTypePolicy.parity().precision():
            assert _tf32() == ("ieee", "ieee")
        assert b.cudnn.allow_tf32 and b.cuda.matmul.allow_tf32
        # and one who set the newer settings
        b.cudnn.conv.fp32_precision = "tf32"
        b.cuda.matmul.fp32_precision = "tf32"
        with pytest.raises(KeyError):
            with float32_exact():
                assert _tf32() == ("ieee", "ieee")
                raise KeyError("leaves the scope by an exception")
        assert _tf32() == ("tf32", "tf32")
        with DTypePolicy.fast().precision():       # bf16: nothing changes
            assert _tf32() == ("tf32", "tf32")
    finally:
        b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision = saved


# (name, frame size): the pyramid net closes at 448x448 only
FAMILIES = [("googlenet_detectnet", 64), ("vgg_detectnet_train", 32),
            ("vgg_pyramid_detectnet", 448), ("fcn8s_bbox", 64),
            ("fcn32s_seg", 32), ("resnet_fpn_detectnet", 64)]


@pytest.mark.parametrize("name,hw", FAMILIES)
def test_bf16_policy_equals_the_bf16_model(name, hw):
    """float32 parameters computing in bf16 (the training policy) give the
    serving default's bf16 outputs exactly: each conv rounds its weights
    to bf16 as the cast model holds them.  Train mode with dropout 0 gives
    them too."""
    rng = np.random.default_rng(5)
    raw = torch.from_numpy(rng.integers(0, 256, (1, hw, hw, 3),
                                        dtype=np.uint8))
    x = raw if name in ("googlenet_detectnet", "resnet_fpn_detectnet") \
        else raw.float() / 255.0
    cast = build(name)
    cast.init_weights(torch.Generator().manual_seed(0))
    # FCN-32s has no dropout
    split = build(name, **({} if name == "fcn32s_seg"
                           else {"dropout_rate": 0.0}))
    split.load_state_dict(cast.state_dict())
    cast.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    DTypePolicy.fast().apply(split).to(memory_format=torch.channels_last)
    assert all(p.dtype == torch.float32 for p in split.parameters())
    with torch.no_grad():
        want = cast(x)
        got = split.train()(x, generator=torch.Generator())
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_dropout_acts_in_train_mode_only():
    x = torch.ones(2, 8, 30, 30).to(memory_format=torch.channels_last)
    assert dropout(x, 0.4, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.4, True, None)
    y = dropout(x, 0.4, True, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.6) < 0.02
    assert torch.all(y[kept] == 1 / 0.6)
    again = dropout(x, 0.4, True, torch.Generator().manual_seed(1))
    assert torch.equal(y, again)
    model = build("googlenet_detectnet")
    model.init_weights(torch.Generator().manual_seed(0))
    frames = torch.zeros(1, 64, 64, 3, dtype=torch.uint8)
    with torch.no_grad():
        evals = model(frames)["coverage"]
        trains = model.train()(frames, generator=torch.Generator()
                               .manual_seed(0))["coverage"]
    assert not torch.equal(evals, trains)
