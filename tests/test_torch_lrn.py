"""torchfcn's plain LRN and Caffe ceil-mode pool against tpufcn.

``lrn_pallas`` has no interpret mode, so the LRN is held against
``tpufcn.ops.caffe_layers.lrn_across_channels``, evaluated in a fresh
interpreter with JAX's persistent compile cache off: the suite's workers
share that cache (``tests/conftest.py``), and the reference must not depend
on which test files ran before it in the same worker or on an executable
another worker compiled; in float32 both sides are also held to a float64
evaluation of the Caffe formula, so a failure names the side that moved.
LRN + pool is held against ``lrn_maxpool_pallas(interpret=True)`` in bf16
(that kernel computes in bf16 and asserts even H and W) and against the
JAX ``lrn_across_channels`` + ``max_pool_caffe`` chain in both dtypes on
odd sizes.  Tolerances: float32
rtol 1e-5 (summation order); bf16 1 ulp (one rounding of the window sum or
rsqrt may differ)."""

import os
import subprocess
import sys
from pathlib import Path

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


LRN_CASES = [(c, dtype) for c in (64, 192) for dtype in DTYPES]
# tpufcn's LRN of each case's input, in float32, written to argv[2]
_JAX_LRN = """
import sys
import numpy as np
import jax.numpy as jnp
from tpufcn.ops import caffe_layers as jcl
out = {}
for key, x in np.load(sys.argv[1]).items():
    dtype = jnp.bfloat16 if key.endswith("bfloat16") else jnp.float32
    y = jcl.lrn_across_channels(jnp.asarray(x, dtype), 5, 1e-4, 0.75)
    out[key] = np.asarray(y.astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


def _lrn_input(c):
    return np.random.default_rng(0).standard_normal((2, 9, 12, c)) \
        .astype(np.float32) * 60


@pytest.fixture(scope="module")
def jax_lrn(tmp_path_factory):
    """tpufcn's LRN of every ``LRN_CASES`` input, from a fresh interpreter
    with the persistent compile cache off."""
    tmp = tmp_path_factory.mktemp("jax_lrn")
    np.savez(tmp / "x.npz", **{f"{c}-{dtype}": _lrn_input(c)
                               for c, dtype in LRN_CASES})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    subprocess.run([sys.executable, "-c", _JAX_LRN, str(tmp / "x.npz"),
                    str(tmp / "y.npz")], check=True, env=env,
                   cwd=Path(__file__).resolve().parents[1], timeout=300)
    return dict(np.load(tmp / "y.npz"))


def _caffe_lrn_f64(x: np.ndarray) -> np.ndarray:
    """x / (1 + 1e-4 / 5 * window sum of x^2)^0.75 in float64."""
    xd = x.astype(np.float64)
    padded = np.pad(xd * xd, [(0, 0)] * (x.ndim - 1) + [(2, 2)])
    c = x.shape[-1]
    win = sum(padded[..., i:i + c] for i in range(5))
    return xd * (1 + 2e-5 * win) ** -0.75


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 192])
def test_lrn_matches_jax(rng, jax_lrn, dtype, c):
    x, _ = _inputs(rng, (2, 9, 12, c), dtype)
    assert np.array_equal(x.float().numpy(),
                          torch.from_numpy(_lrn_input(c)).to(x.dtype)
                          .float().numpy())
    got, want = cl.lrn_across_channels(x), jax_lrn[f"{c}-{dtype}"]
    if dtype == "float32":   # each side against float64: which one moved
        exact = _caffe_lrn_f64(_lrn_input(c))
        for side, y in (("torchfcn", got.numpy()), ("tpufcn", want)):
            np.testing.assert_allclose(y, exact, rtol=1e-6, atol=0,
                                       err_msg=f"{side} against float64")
    _assert_close(got, want, dtype)


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
