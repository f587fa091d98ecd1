"""torchfcn's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it runs on a GPU host without it; the suite's conftest imports
JAX, hence ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import chain_rects
from torchfcn.ops.caffe_layers import lrn_across_channels, max_pool_caffe
from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
from torchfcn.ops.cuda.lrn import lrn_cuda
from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda
from torchfcn.ops.cuda.stem import stem_tail_cuda
from torchfcn.ops.group_rects import group_rectangles
from torchfcn.ops.stem import stem_tail

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _instances(rng, m, n):
    """Clustered corner boxes (with a few singletons) under random masks."""
    rects = rng.uniform(-100, 500, (m, n, 4)).astype(np.float32)
    for i in range(m):
        at = 0
        while at < n * 3 // 4:
            x1, y1 = rng.uniform(-20, 400, 2)
            proto = np.array([x1, y1, x1 + rng.uniform(20, 150),
                              y1 + rng.uniform(20, 150)])
            size = min(int(rng.integers(1, 12)), n - at)
            rects[i, at:at + size] = proto + rng.normal(0, 3, (size, 4))
            at += size
    valid = rng.random((m, n)) < 0.8
    return torch.from_numpy(rects), torch.from_numpy(valid)


def _assert_grouped_equal(got, want):
    for field in ("rects", "weights", "valid"):
        a, b = getattr(got, field).cpu(), getattr(want, field).cpu()
        assert torch.equal(a, b), f"{field}: {int((a != b).sum())} differ"


# up to 1024 one candidate per thread; beyond, several per thread: the
# default capacity of fcn8s_bbox (36 x 36 cells at 288x288) and the most
# the kernel takes
@pytest.mark.parametrize("m,n", [(1, 32), (4, 100), (32, 256), (5, 784),
                                 (2, 1024), (1, 1025), (8, 1296), (3, 2000),
                                 (2, 4096)])
def test_group_rects_kernel_matches_plain(dev, rng, m, n):
    rects, valid = _instances(rng, m, n)
    got = group_rectangles_cuda(rects.to(dev), valid.to(dev))
    torch.cuda.synchronize()
    _assert_grouped_equal(got, group_rectangles(rects, valid))


def _one_component(rng, n):
    """n boxes within 2 px of one box: every pair similar."""
    rects = np.array([50., 60., 120., 130.], np.float32) + \
        rng.integers(-2, 3, (2, n, 4)).astype(np.float32)
    return torch.from_numpy(rects), torch.ones(2, n, dtype=torch.bool)


def _all_invalid(rng, n):
    rects, valid = _instances(rng, 3, n)
    return rects, torch.zeros_like(valid)


@pytest.mark.parametrize("case,n", [(chain_rects, 256),
                                    (chain_rects, 1023),
                                    (chain_rects, 1296),
                                    (chain_rects, 4096),
                                    (_one_component, 256),
                                    (_one_component, 1024),
                                    (_one_component, 4096),
                                    (_all_invalid, 256),
                                    (_all_invalid, 1296)])
def test_group_rects_kernel_matches_plain_on_hard_inputs(dev, rng, case, n):
    rects, valid = case(rng, n)
    got = group_rectangles_cuda(rects.to(dev), valid.to(dev))
    torch.cuda.synchronize()
    want = group_rectangles(rects, valid)
    _assert_grouped_equal(got, want)
    if case is chain_rects:   # the whole chain is one cluster
        assert want.weights.max() == n


def test_group_rects_kernel_rounds_means_half_to_even(dev):
    """Clusters of 4 whose coordinate sums end in .5 after division."""
    base = torch.tensor([[10., 20., 110., 120.], [-31., -41., 69., 79.]])
    # offsets summing to 2 over 4 members: mean = proto + 0.5
    offs = torch.tensor([[0.], [0.], [1.], [1.]])
    rects = torch.cat([b + offs for b in base])[None]       # (1, 8, 4)
    rects = torch.cat([rects, torch.zeros(1, 24, 4)], dim=1)
    valid = torch.arange(32)[None] < 8
    want = group_rectangles(rects, valid, group_threshold=3)
    got = group_rectangles_cuda(rects.to(dev), valid.to(dev), 3)
    torch.cuda.synchronize()
    _assert_grouped_equal(got, want)
    # 10.5 -> 10, 20.5 -> 20, 110.5 -> 110, 120.5 -> 120; negatives alike
    assert want.valid.sum() == 2
    assert want.rects[0, 0].tolist() == [10., 20., 110., 120.]
    assert want.rects[0, 4].tolist() == [-30., -40., 70., 80.]


def test_group_rects_kernel_rejects_what_it_does_not_take(dev):
    rects = torch.zeros(2, 64, 4, device=dev)
    valid = torch.ones(2, 64, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        group_rectangles_cuda(rects.double(), valid)
    with pytest.raises(ValueError):
        group_rectangles_cuda(rects.transpose(0, 1).contiguous()
                              .transpose(0, 1), valid)
    with pytest.raises(ValueError):       # beyond MAX_CANDIDATES = 4096
        group_rectangles_cuda(torch.zeros(1, 4097, 4, device=dev),
                              torch.ones(1, 4097, dtype=torch.bool,
                                         device=dev))


def _bf16_ulp(t):
    _, exp = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exp - 8)


def _assert_lrn_close(got, want):
    """bf16 within 1 ulp (rsqrt and summation order may differ by one
    rounding), float32 within rtol 1e-5."""
    if got.dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs().cpu()
        assert (err <= _bf16_ulp(want).cpu()).all()
    else:
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-5, atol=0)


MISALIGNED = "misaligned"


def _lrn_input(rng, dev, dtype, shape):
    """Seeded N(0, 60^2) values of ``shape``; for ``(MISALIGNED, *shape)``
    a view one element past an aligned allocation, which takes the LRN
    kernels' scalar instance."""
    misaligned = shape[0] == MISALIGNED
    shape = shape[1:] if misaligned else shape
    x = (torch.from_numpy(rng.standard_normal(shape, np.float32)) * 60
         ).to(dev, dtype)
    if misaligned:
        view = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:]
        x = view.view(shape).copy_(x)
        assert x.data_ptr() % 16
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the vector instance at the main path's shape and at odd shapes; the
# scalar instance with 3 channels and on a misaligned view
@pytest.mark.parametrize("shape", [(2, 112, 112, 64), (3, 7, 5, 192),
                                   (4, 9, 3), (10, 2), (8, 57, 45, 192),
                                   (2, 15, 13, 3),
                                   (MISALIGNED, 2, 15, 13, 64)])
def test_lrn_kernel_matches_plain(dev, rng, dtype, shape):
    x = _lrn_input(rng, dev, dtype, shape)
    got = lrn_cuda(x)
    torch.cuda.synchronize()
    _assert_lrn_close(got, lrn_across_channels(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the main path's shape (bf16; float32 in the parity run), B = 8 with odd H
# and W (at (8, 47, 45) a short last stripe and a short last column tile),
# the scalar instance with 3 channels and on a misaligned view
@pytest.mark.parametrize("shape", [(2, 112, 112, 192), (1, 15, 17, 64),
                                   (2, 4, 3, 8), (8, 112, 112, 192),
                                   (8, 57, 45, 192), (8, 70, 33, 64),
                                   (8, 47, 45, 192),
                                   (2, 15, 13, 3),
                                   (MISALIGNED, 2, 15, 13, 64)])
def test_lrn_maxpool_kernel_matches_plain(dev, rng, dtype, shape):
    x = _lrn_input(rng, dev, dtype, shape)
    got = lrn_maxpool_cuda(x)
    torch.cuda.synchronize()
    want = max_pool_caffe(lrn_across_channels(x), 3, 2)
    assert got.shape == want.shape
    _assert_lrn_close(got, want)


def test_lrn_kernels_reject_what_they_do_not_take(dev):
    x = torch.ones(1, 8, 8, 16, device=dev)
    with pytest.raises(TypeError):
        lrn_cuda(x.half())
    with pytest.raises(ValueError):
        lrn_cuda(x.permute(0, 3, 1, 2))
    with pytest.raises(ValueError):
        lrn_cuda(x[0, 0, 0, 0])
    with pytest.raises(ValueError):
        lrn_maxpool_cuda(x[:, :2])


def test_launch_counters_count_kernel_launches_only(dev):
    x = torch.ones(1, 8, 8, 16, device=dev)
    before = lrn_cuda.launches
    lrn_cuda(x)
    lrn_cuda(x.cpu())          # plain version: not a launch
    assert lrn_cuda.launches == before + 1


def _stem_weights(rng, dev):
    """Xavier-scale conv2_reduce / conv2 weights with random biases, bf16."""
    shapes = ((64, 64, 1, 1), (64,), (192, 64, 3, 3), (192,))
    scales = (3 ** 0.5 / 8, 0.1, 3 ** 0.5 / 24, 0.1)
    return [torch.from_numpy((rng.uniform(-1, 1, s) * a).astype(np.float32))
            .to(dev, torch.bfloat16) for s, a in zip(shapes, scales)]


def _e5m2_steps(a, b):
    def ordinal(t):
        code = t.view(torch.uint8).int()
        return torch.where(code >= 128, -(code & 127), code & 127)
    return (ordinal(a) - ordinal(b)).abs()


@pytest.mark.parametrize("store", [None, torch.float8_e5m2])
# at B = 8 stripes of several pool rows: the serving shape, an odd H (14
# stripes of 2) and a short last stripe (Ho = 35 in stripes of 3); at
# B <= 3 one pool row per stripe, with pool, width and tile edges
@pytest.mark.parametrize("shape", [(8, 112, 112, 64), (8, 57, 45, 64),
                                   (8, 70, 33, 64), (1, 30, 30, 64),
                                   (2, 57, 45, 64), (1, 3, 3, 64),
                                   (1, 9, 128, 64), (3, 20, 17, 64)])
def test_stem_tail_kernel_matches_plain(dev, rng, store, shape):
    """Against the plain version with TF32 off: at least 99.9 % of the
    entries bit-equal; the rest within max(0.26, 2 bf16 ulps) in bf16 (0.26
    is the JAX package's stem-kernel tolerance) and one e5m2 step in e5m2.
    The kernel and cuDNN sum in other orders, and a flipped rounding of an
    intermediate moves the conv sums downstream of it by a weight times
    its ulp."""
    torch.backends.cudnn.allow_tf32 = False
    weights = _stem_weights(rng, dev)
    x = (torch.from_numpy(np.abs(rng.standard_normal(shape, np.float32)))
         * 40).to(dev, store or torch.bfloat16)
    got = stem_tail_cuda(x, *weights, store)
    want = stem_tail(x, *weights, store)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (shape[0], shape[1] // 2,
                                       shape[2] // 2, 192)
    assert got.dtype == want.dtype == (store or torch.bfloat16)
    g, w = got.float(), want.float()
    assert (g == w).float().mean() >= 0.999
    if store is None:
        assert ((g - w).abs() <= torch.clamp(2 * _bf16_ulp(w), min=0.26)
                ).all()
    else:
        assert (_e5m2_steps(got, want) <= 1).all()


def test_stem_tail_kernel_rejects_what_it_does_not_take(dev, rng):
    weights = _stem_weights(rng, dev)
    x = torch.ones(1, 8, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):          # input not in the storage type
        stem_tail_cuda(x, *weights, torch.float8_e5m2)
    with pytest.raises(TypeError):
        stem_tail_cuda(x.float(), *weights)
    with pytest.raises(ValueError):
        stem_tail_cuda(x[..., :32].contiguous(), *weights)
    with pytest.raises(ValueError):         # too wide for shared memory
        stem_tail_cuda(torch.ones(1, 8, 200, 64, device=dev,
                                  dtype=torch.bfloat16), *weights)
    before = stem_tail_cuda.launches
    stem_tail_cuda(x, *weights)
    stem_tail_cuda(x.cpu(), *(w.cpu() for w in weights))
    assert stem_tail_cuda.launches == before + 1
