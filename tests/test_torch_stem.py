"""torchfcn's stem tail (``torchfcn/ops/stem.py``, the plain version of the
``stem_tail`` CUDA kernel) against tpufcn's Pallas stem kernel in interpret
mode, and its e5m2 variant against the JAX serving model's chain; and the
CUDA wrapper's host-side geometry (shared memory, stripe plan, the inputs it
refuses), which the CPU reaches without the kernel.

bf16: the tolerance of the JAX package's own kernel test
(``tests/test_pallas_kernels.py:61-64``): atol 0.26, and more than 97 % of
the entries within 1e-3.  e5m2: at least 97 % of the entries bit-equal and
none more than one e5m2 step apart; measured 100 % bit-equal at both sizes
(the two chains differ only in float32 summation order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpufcn.ops.caffe_layers import lrn_across_channels, max_pool_caffe
from tpufcn.ops.pallas.stem import googlenet_stem_pallas, stem_tail_pallas
from torchfcn.ops.caffe_layers import pooled_size
from torchfcn.ops.cuda import stem as stem_cuda
from torchfcn.ops.cuda.geometry import SHARED_BYTES_MAX
from torchfcn.ops.cuda.stem import stem_tail_cuda
from torchfcn.ops.stem import googlenet_stem, stem_tail

torch.set_num_threads(2)

E5M2 = jnp.float8_e5m2


def _weights(rng):
    """The JAX test's stem weights (HWIO) and their port layout (OIHW)."""
    ws = (
        (rng.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32),
        (rng.standard_normal(64) * 0.1).astype(np.float32),
        (rng.standard_normal((1, 1, 64, 64)) * 0.05).astype(np.float32),
        (rng.standard_normal(64) * 0.1).astype(np.float32),
        (rng.standard_normal((3, 3, 64, 192)) * 0.05).astype(np.float32),
        (rng.standard_normal(192) * 0.1).astype(np.float32),
    )
    port = tuple(torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 2, 0, 1) if w.ndim == 4 else w)) for w in ws)
    return ws, port


def _assert_stem_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.26)
    assert (np.abs(got - want) < 1e-3).mean() > 0.97


@pytest.mark.parametrize("H", [64, 128])
def test_googlenet_stem_matches_pallas(rng, H):
    ws, port = _weights(rng)
    x = rng.integers(0, 256, (2, H, H, 3)).astype(np.uint8)
    want = np.asarray(googlenet_stem_pallas(jnp.asarray(x), *ws,
                                            interpret=True), np.float32)
    got = googlenet_stem(torch.from_numpy(x), *port)
    assert got.dtype == torch.bfloat16
    _assert_stem_close(got.float().numpy(), want)


def test_stem_tail_matches_pallas_at_stripe_seams(rng):
    """The Pallas kernel's 14-row stripe seams and the ceil edge at 448."""
    ws, port = _weights(rng)
    x = rng.integers(0, 256, (1, 448, 448, 3)).astype(np.uint8)
    want = np.asarray(googlenet_stem_pallas(jnp.asarray(x), *ws,
                                            interpret=True), np.float32)
    got = googlenet_stem(torch.from_numpy(x), *port).float().numpy()
    for row in (13, 14, 27, 28, 41, 42, 55):
        _assert_stem_close(got[0, row], want[0, row])


@pytest.mark.parametrize("H", [16, 30])
def test_stem_tail_matches_pallas_tail(rng, H):
    """The tail alone on bf16 pool1 outputs, even and ceil-edge sizes."""
    ws, port = _weights(rng)
    p1 = np.abs(rng.standard_normal((2, H, H, 64)) * 40).astype(np.float32)
    p1 = jnp.asarray(p1, jnp.bfloat16)
    want = np.asarray(stem_tail_pallas(p1, *ws[2:], interpret=True),
                      np.float32)
    got = stem_tail(torch.from_numpy(np.asarray(p1, np.float32)).bfloat16(),
                    *port[2:])
    _assert_stem_close(got.float().numpy(), want)


def _jax_serving_tail(p1, wr, br, w2, b2):
    """tpufcn's serving chain (googlenet.py:191-200 with caffe_layers.py:55-60)
    on an e5m2 pool1 output, each conv rounded as the TPU kernel rounds."""
    def conv(x, w, b, pad):
        y = jax.lax.conv_general_dilated(
            x.astype(jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), (1, 1),
            [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)
        return jnp.maximum(y + b, 0).astype(jnp.bfloat16).astype(E5M2)

    x = lrn_across_channels(p1).astype(jnp.bfloat16).astype(E5M2)
    x = conv(x, wr, br, 0)
    x = conv(x, w2, b2, 1)
    x = lrn_across_channels(x.astype(jnp.bfloat16)).astype(
        jnp.bfloat16).astype(E5M2)
    return max_pool_caffe(x, 3, 2)


def e5m2_steps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many e5m2 values apart two e5m2 arrays are, entrywise."""
    def ordinal(v):
        code = v.view(np.uint8).astype(np.int32)
        return np.where(code & 0x80, -(code & 0x7F), code & 0x7F)
    return np.abs(ordinal(a) - ordinal(b))


@pytest.mark.parametrize("H", [16, 30])
def test_stem_tail_e5m2_matches_serving_chain(rng, H):
    ws, port = _weights(rng)
    p1 = np.abs(rng.standard_normal((2, H, H, 64)) * 40).astype(np.float32)
    p1 = jnp.asarray(p1, jnp.bfloat16).astype(E5M2)
    want = np.asarray(jax.jit(_jax_serving_tail)(p1, *ws[2:]))
    got = stem_tail(torch.from_numpy(np.asarray(p1.astype(jnp.float32)))
                    .to(torch.float8_e5m2), *port[2:],
                    store_dtype=torch.float8_e5m2)
    assert got.dtype == torch.float8_e5m2 and got.shape == want.shape
    steps = e5m2_steps(got.view(torch.uint8).numpy().view(want.dtype), want)
    assert steps.max() <= 1
    assert (steps == 0).mean() >= 0.97


def test_stem_tail_cuda_runs_the_plain_version_on_cpu(rng):
    _, port = _weights(rng)
    p1 = torch.from_numpy(np.abs(rng.standard_normal((1, 12, 10, 64)) * 40)
                          .astype(np.float32)).to(torch.float8_e5m2)
    before = stem_tail_cuda.launches
    for store in (None, torch.float8_e5m2):
        x = p1 if store else p1.bfloat16()
        got = stem_tail_cuda(x, *port[2:], store_dtype=store)
        assert torch.equal(got.float(), stem_tail(x, *port[2:], store).float())
        assert got.shape == (1, 6, 5, 192)
    assert stem_tail_cuda.launches == before


# ---- the stem kernel's host-side geometry (torchfcn/ops/cuda/stem.py) ----

NUM_SMS = 132                  # H100 SXM


@pytest.mark.parametrize("w", [3, 45, 112, stem_cuda.MAX_WIDTH])
def test_stem_kernel_shared_memory_fits(w):
    """One block's shared memory fits the H100's 232,448 bytes at the
    serving width and up to the widest width the wrapper takes."""
    assert stem_cuda.shared_bytes(w) <= SHARED_BYTES_MAX
    assert all(stem_cuda.shared_bytes(v) <= SHARED_BYTES_MAX
               for v in range(3, stem_cuda.MAX_WIDTH + 1))


def test_stem_kernel_shared_memory_at_the_serving_width():
    """The byte counts the kernel's source note states (ring 43,776 +
    taps 73,728 + reduce weights 8,192 + staging 44,800 + pooled row
    21,504 + biases 1,024 at W = 112)."""
    assert stem_cuda.shared_bytes(112) == 193024
    assert stem_cuda.shared_bytes(128) == 208640


@pytest.mark.parametrize("batch", [1, 2, 8, 64, 300])
def test_stem_stripe_plan_covers_every_pool_row_once(batch):
    for h in range(3, 121):
        ho = pooled_size(h, 3, 2)
        rows, stripes = stem_cuda.stripe_plan(batch, ho, NUM_SMS)
        covered = [oh for s in range(stripes)
                   for oh in range(s * rows, min((s + 1) * rows, ho))]
        assert covered == list(range(ho)), (h, rows, stripes)
        assert (stripes - 1) * rows < ho        # no stripe is empty
        # one wave on the card where the batch allows it
        assert batch * stripes <= max(NUM_SMS, batch)


def test_stem_stripe_plan_at_the_serving_shape():
    assert stem_cuda.stripe_plan(8, 56, NUM_SMS) == (4, 14)    # 112 blocks
    assert stem_cuda.stripe_plan(1, 56, NUM_SMS) == (1, 56)
    # the card checks' edge shapes at B = 8: odd H, short last stripe
    assert stem_cuda.stripe_plan(8, 28, NUM_SMS) == (2, 14)
    assert stem_cuda.stripe_plan(8, 35, NUM_SMS) == (3, 12)


def _stem_args(h=8, w=8, c=64, dtype=torch.bfloat16):
    x = torch.zeros(1, h, w, c, dtype=dtype)
    return [x, torch.zeros(64, 64, 1, 1), torch.zeros(64),
            torch.zeros(192, 64, 3, 3), torch.zeros(192)]


@pytest.mark.parametrize("case,store,error", [
    (dict(dtype=torch.float32), None, TypeError),          # not bf16
    (dict(), torch.float8_e5m2, TypeError),                # not e5m2
    (dict(), torch.float16, TypeError),                    # no such store
    (dict(c=32), None, ValueError),                        # channels
    (dict(h=2), None, ValueError),                         # 3x3 pool
    (dict(w=2), None, ValueError),
    (dict(w=stem_cuda.MAX_WIDTH + 1), None, ValueError),   # too wide
])
def test_stem_wrapper_rejects_what_the_kernel_does_not_take(case, store,
                                                            error):
    with pytest.raises(error):
        stem_cuda.check_inputs(*_stem_args(**case), store)


def test_stem_wrapper_rejects_bad_layouts_and_weights():
    args = _stem_args(w=16)
    with pytest.raises(ValueError):                        # not contiguous
        stem_cuda.check_inputs(args[0][:, :, ::2], *args[1:], None)
    with pytest.raises(ValueError):
        stem_cuda.check_inputs(args[0], args[1], args[2],
                               torch.zeros(192, 64, 1, 1), args[4], None)
    assert stem_cuda.check_inputs(*args, None) == torch.bfloat16
    args[0] = args[0].to(torch.float8_e5m2)
    assert stem_cuda.check_inputs(*args, torch.float8_e5m2) \
        == torch.float8_e5m2
    assert stem_cuda.check_inputs(*_stem_args(w=stem_cuda.MAX_WIDTH),
                                  None) == torch.bfloat16
