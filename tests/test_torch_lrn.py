"""torchfcn's plain LRN and Caffe ceil-mode pool against tpufcn.

``lrn_pallas`` has no interpret mode, so the LRN is held against
``tpufcn.ops.caffe_layers.lrn_across_channels``.  LRN + pool is held against
``lrn_maxpool_pallas(interpret=True)`` in bf16 (that kernel computes in bf16
and asserts even H and W) and against the JAX ``lrn_across_channels`` +
``max_pool_caffe`` chain in both dtypes on odd sizes.  Tolerances: float32
rtol 1e-5 (summation order); bf16 1 ulp (one rounding of the window sum or
rsqrt may differ)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpufcn.ops import caffe_layers as jcl
from tpufcn.ops.pallas.lrn_pool import lrn_maxpool_pallas
from torchfcn.ops import caffe_layers as cl
from torchfcn.ops.cuda.lrn import lrn_cuda
from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32) * 60
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _assert_close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 192])
def test_lrn_matches_jax(rng, dtype, c):
    x, xj = _inputs(rng, (2, 9, 12, c), dtype)
    _assert_close(cl.lrn_across_channels(x),
                  jcl.lrn_across_channels(xj, 5, 1e-4, 0.75), dtype)


@pytest.mark.parametrize("c", [64, 192])
def test_lrn_maxpool_matches_pallas_interpret(rng, c):
    x, xj = _inputs(rng, (2, 16, 12, c), "bfloat16")
    got = cl.max_pool_caffe(cl.lrn_across_channels(x), 3, 2)
    _assert_close(got, lrn_maxpool_pallas(xj, interpret=True), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 192])
def test_lrn_maxpool_odd_sizes_match_jax_chain(rng, dtype, c):
    x, xj = _inputs(rng, (2, 15, 13, c), dtype)
    got = cl.max_pool_caffe(cl.lrn_across_channels(x), 3, 2)
    want = jcl.max_pool_caffe(jcl.lrn_across_channels(xj), 3, 2)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("kernel,stride,pad", [(3, 2, 0), (3, 1, 1)])
@pytest.mark.parametrize("hw", [(15, 13), (16, 12), (7, 8)])
def test_max_pool_caffe_matches_jax(rng, kernel, stride, pad, hw):
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    got = cl.max_pool_caffe(torch.from_numpy(x), kernel, stride, pad)
    want = np.asarray(jcl.max_pool_caffe(jnp.asarray(x), kernel, stride, pad))
    assert np.array_equal(got.numpy(), want)


def test_pooled_size_matches_jax():
    for n in range(3, 40):
        for kernel, stride, pad in ((3, 2, 0), (3, 1, 1), (2, 2, 0),
                                    (3, 2, 1), (5, 3, 2)):
            want, _ = jcl._ceil_pool_extra(n, kernel, stride, pad)
            assert cl.pooled_size(n, kernel, stride, pad) == want


def test_wrappers_take_plain_versions_on_cpu_only(rng):
    x, _ = _inputs(rng, (1, 8, 6, 64), "bfloat16")
    counts = (lrn_cuda.launches, lrn_maxpool_cuda.launches)
    assert torch.equal(lrn_cuda(x), cl.lrn_across_channels(x))
    assert torch.equal(lrn_maxpool_cuda(x),
                       cl.max_pool_caffe(cl.lrn_across_channels(x), 3, 2))
    assert (lrn_cuda.launches, lrn_maxpool_cuda.launches) == counts
    with pytest.raises(ValueError):
        lrn_cuda(x.to("meta"))
    with pytest.raises(ValueError):
        lrn_maxpool_cuda(x.to("meta"))
