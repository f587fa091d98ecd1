"""torchfcn's Caffe primitives of the VGG and FCN families and their
demean preprocessing against tpufcn's, on seeded inputs.

Tolerances, all on float32: the pyramid's average pools within rtol 1e-6
(tpufcn sums at most k^2 float32 values, the port the same values in
float64); the upsample forms within
atol 1e-6 on unit-scale inputs (tpufcn sums float32 products, the port's
separable form float64 ones, rounded once); demean exact (elementwise
float32 with the same roundings)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpufcn.ops import caffe_layers as jax_cl
from tpufcn.ops.image import demean_bgr as jax_demean
from tpufcn.ops.image import preprocess_bgr as jax_preprocess
from torchfcn.models.layers import nchw, nhwc, upsample_factor
from torchfcn.models.vgg import pyramid_pool
from torchfcn.ops import caffe_layers as cl
from torchfcn.ops.image import demean_bgr, preprocess_bgr

torch.set_num_threads(2)


def _pyramid_avg_pool(x, k):
    """The VGG pyramid's Caffe average pool (k x k, stride k, no padding)
    of an NHWC map, the input dtype out."""
    sums, div = pyramid_pool(nchw(x).to(torch.float64), k, 0, x.shape[1])
    return nhwc((sums / div).to(x.dtype))


# (H, W, kernel): the pyramid's exact-fit adaptive pools at 56x56, and ceil
# slack past the edge (odd sizes)
@pytest.mark.parametrize("h,w,k", [(56, 56, 56), (56, 56, 8), (56, 56, 14),
                                   (7, 9, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avg_pool_matches_jax(rng, h, w, k, dtype):
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32) * 3
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = _pyramid_avg_pool(tx, k)
    want = np.asarray(jax_cl.avg_pool_caffe(
        jnp.asarray(tx.float().numpy()).astype(dtype), k, k)
        .astype(jnp.float32))
    assert got.dtype == tx.dtype
    assert got.shape[1:3] == (cl.pooled_size(h, k, k),
                              cl.pooled_size(w, k, k)) == want.shape[1:3]
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:   # one bf16 rounding of sums that agree to 1e-6
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-6)


def test_avg_pool_divisor_leaves_out_the_ceil_slack():
    """A 3x3 input pooled 2x2/2: the edge windows hold 2 and 1 values and
    are divided by just those (Caffe's hend = min(hstart + k, in + pad))."""
    x = torch.arange(9, dtype=torch.float32).reshape(1, 3, 3, 1)
    got = _pyramid_avg_pool(x, 2)[0, ..., 0]
    assert got.tolist() == [[2.0, 3.5], [6.5, 8.0]]


def test_bilinear_filler_and_matrix_match_jax():
    for k in (4, 8, 13, 14, 16, 32, 56):
        assert np.array_equal(cl.bilinear_kernel(k).numpy(),
                              np.asarray(jax_cl.bilinear_kernel(k)))
        for n, s, p in ((1, 28, 14), (7, 4, 2), (5, 7, 3)):
            assert np.array_equal(
                cl.bilinear_upsample_matrix(n, k, s, p),
                jax_cl.bilinear_upsample_matrix(n, k, s, p))


# (kernel, stride, pad, grid): every reference deconv (fcn32s k32 s16 p8,
# fcn8s k16 s8 p4 / k8 s4 p2 / k4 s2 p1) and the pyramid's factors 28, 14,
# 7 and 4, plus the odd factor 13 (k25 s13 p6)
def _factor(f):
    return 2 * f - f % 2, f, math.ceil((f - 1) / 2)


UPSAMPLES = [(32, 16, 8, (14, 14)), (16, 8, 4, (9, 9)), (8, 4, 2, (7, 5)),
             (4, 2, 1, (6, 9)), (*_factor(28), (1, 1)), (*_factor(14), (2, 2)),
             (*_factor(7), (4, 4)), (*_factor(4), (7, 7)),
             (*_factor(13), (3, 2))]


@pytest.mark.parametrize("k,s,p,grid", UPSAMPLES)
def test_upsample_forms_match_jax(rng, k, s, p, grid):
    x = rng.standard_normal((2, *grid, 6)).astype(np.float32)
    want = np.asarray(jax_cl.upsample_bilinear_separable(jnp.asarray(x),
                                                         k, s, p))
    sep = cl.upsample_bilinear_separable(torch.from_numpy(x), k, s, p)
    deconv = cl.upsample_bilinear_caffe(torch.from_numpy(x), k, s, p)
    out = ((grid[0] - 1) * s + k - 2 * p, (grid[1] - 1) * s + k - 2 * p)
    assert sep.shape == deconv.shape == (2, *out, 6) == want.shape
    assert sep.dtype == deconv.dtype == torch.float32
    assert sep.is_contiguous()
    np.testing.assert_allclose(sep.numpy(), want, rtol=0, atol=1e-6)
    # the separable form is the depthwise deconvolution
    np.testing.assert_allclose(sep.numpy(), deconv.numpy(), rtol=0, atol=1e-6)
    jax_deconv = np.asarray(jax_cl.upsample_bilinear_caffe(jnp.asarray(x),
                                                           k, s, p))
    np.testing.assert_allclose(deconv.numpy(), jax_deconv, rtol=0, atol=1e-5)


def test_separable_upsample_rounds_once_to_the_input_dtype(rng):
    x = torch.from_numpy(rng.standard_normal((1, 5, 4, 3)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = cl.upsample_bilinear_separable(xb, 4, 2, 1)
    assert got.dtype == torch.bfloat16
    wide = cl.upsample_bilinear_separable(xb.double(), 4, 2, 1)
    assert torch.equal(got, wide.to(torch.bfloat16))


def test_upsample_factor_geometry(rng):
    """k = 2f - f%2, s = f, p = ceil((f - 1) / 2) on the module layout."""
    for f, n in ((2, 14), (4, 7), (7, 4), (13, 3), (14, 2), (28, 1)):
        x = torch.from_numpy(rng.standard_normal((1, n, n, 2))
                             .astype(np.float32))
        got = upsample_factor(nchw(x), f)
        assert got.shape == (1, 2, n * f, n * f)
        want = cl.upsample_bilinear_separable(x, *_factor(f))
        assert torch.equal(nhwc(got), want)


def test_conv_transpose_caffe_geometry():
    """One input pixel through a 3x3 ramp kernel at stride 2, pad 1."""
    x = torch.zeros(1, 2, 2, 1)
    x[0, 0, 0, 0] = 1.0
    w = torch.arange(9, dtype=torch.float32).reshape(3, 3, 1, 1)
    got = cl.conv_transpose_caffe(x, w, 2, 1)
    assert got.shape == (1, 3, 3, 1)                  # (2-1)*2 + 3 - 2
    want = np.asarray(jax_cl.conv_transpose_caffe(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), 2, 1))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 32, 24, 3), (3, 5, 3)])
def test_demean_matches_jax(rng, shape):
    img = rng.integers(0, 256, shape).astype(np.uint8)
    got = demean_bgr(torch.from_numpy(img))
    want = np.asarray(jax_demean(jnp.asarray(img)))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    flat = got.reshape(-1, int(np.prod(shape[-3:]))) if len(shape) == 4 \
        else got.reshape(1, -1)
    assert (flat.amin(-1) == 0).all() and (flat.amax(-1) == 1).all()


def test_demean_constant_frame_maps_to_zero():
    img = np.full((2, 8, 8, 3), 77, np.uint8)
    img[1] = 200
    got = demean_bgr(torch.from_numpy(img))
    want = np.asarray(jax_demean(jnp.asarray(img)))
    assert np.isfinite(got.numpy()).all()
    assert np.array_equal(got.numpy(), want)
    # the channel means differ, so only a frame constant after the demean
    # maps to exactly zero
    flat = np.full((1, 4, 4, 3), 0, np.float32) + np.float32(
        [104.0069879317889, 116.66876761696767, 122.6789143406786])
    assert not demean_bgr(torch.from_numpy(flat)).any()


def test_preprocess_demeans_before_resizing(rng):
    img = rng.integers(0, 256, (2, 60, 80, 3)).astype(np.uint8)
    got = preprocess_bgr(torch.from_numpy(img), (32, 48))
    want = np.asarray(jax_preprocess(jnp.asarray(img), (32, 48)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    same = preprocess_bgr(torch.from_numpy(img), (60, 80))
    assert torch.equal(same, demean_bgr(torch.from_numpy(img)))
