"""The LRN kernels' host-side choices (``torchfcn/ops/cuda/lrn.py``,
``lrn_pool.py``), on the CPU: which instance an input takes, and the
geometry each kernel is launched with, which the kernels check again."""

import pytest
import torch

from torchfcn.ops.caffe_layers import pooled_size
from torchfcn.ops.cuda.geometry import SHARED_BYTES_MAX, blocks_fit
from torchfcn.ops.cuda.lrn import lrn_plan, vector_instance
from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_plan

NUM_SMS = 132                  # H100 SXM
DTYPES = (torch.float32, torch.bfloat16)


def _instances(dtype, c):
    """The instances an input of ``c`` channels can take."""
    return (False, True) if vector_instance(dtype, c, 0) else (False,)


def _covered_once(size: int, per: int, count: int) -> bool:
    """``count`` consecutive runs of ``per`` cover 0 .. size - 1 exactly
    once, none of them empty."""
    covered = [i for s in range(count)
               for i in range(s * per, min((s + 1) * per, size))]
    return covered == list(range(size)) and (count - 1) * per < size


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 3, 8, 64, 192, 512])
def test_lrn_maxpool_plan_covers_every_pool_row_and_column_once(dtype, c):
    itemsize = dtype.itemsize
    for vector in _instances(dtype, c):
        for h in range(3, 121):
            ho = pooled_size(h, 3, 2)
            for w in range(3, 121):
                wo = pooled_size(w, 3, 2)
                rows, stripes, tile, tiles, smem = lrn_maxpool_plan(
                    8, h, w, c, itemsize, vector, NUM_SMS)
                assert _covered_once(ho, rows, stripes), (h, w, vector)
                assert _covered_once(wo, tile, tiles), (h, w, vector)
                assert smem <= SHARED_BYTES_MAX and blocks_fit(smem) >= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [1, 3, 8, 64, 192, 512, 4464])
def test_lrn_plan_tiles_every_pixel_once(dtype, c):
    for vector in _instances(dtype, c):
        for pixels in (1, 7, 100, 4097, 8 * 112 * 112, 8 * 57 * 45):
            tile, blocks, smem = lrn_plan(pixels, c, dtype.itemsize, vector,
                                          NUM_SMS)
            tiles = -(-pixels // tile)
            assert _covered_once(pixels, tile, tiles)
            assert 1 <= blocks <= min(tiles, 4 * NUM_SMS)
            assert smem <= SHARED_BYTES_MAX and blocks_fit(smem) >= 1
            if vector:   # 16-byte rows: every tile starts 16-byte aligned
                assert tile * c * dtype.itemsize % 16 == 0


def test_main_path_shapes_take_the_vector_instance():
    """norm1 (8, 112, 112, 64) and norm2 + pool2 (8, 112, 112, 192) in
    bf16, from a fresh (aligned) allocation, and the float32 parity run."""
    for c in (64, 192):
        for dtype in DTYPES:
            x = torch.empty(1, 2, 2, c, dtype=dtype)
            assert vector_instance(dtype, c, x.data_ptr())
    # 4 tiles of 14 pool columns x 8 stripes of 7 pool rows x 8 images:
    # 256 blocks, 2 on each SM (the smaller bf16 blocks would fit 4)
    plan = lrn_maxpool_plan(8, 112, 112, 192, 2, True, NUM_SMS)
    assert plan == (7, 8, 14, 4, 49984)
    assert blocks_fit(plan[-1]) == 4
    f32 = lrn_maxpool_plan(8, 112, 112, 192, 4, True, NUM_SMS)
    assert f32 == (7, 8, 14, 4, 99904) and blocks_fit(f32[-1]) == 2
    # lrn: tiles of 64 pixels (8 KB), 528 persistent blocks
    assert lrn_plan(8 * 112 * 112, 64, 2, True, NUM_SMS) == (64, 528, 24640)


@pytest.mark.parametrize("dtype", DTYPES)
def test_odd_channels_and_misaligned_views_take_the_scalar_instance(dtype):
    assert not vector_instance(dtype, 3, 0)
    assert not vector_instance(dtype, 2, 0)
    assert vector_instance(dtype, 8, 0)
    assert not vector_instance(dtype, 8, dtype.itemsize)
    n = 2 * 15 * 13 * 64
    view = torch.empty(n + 1, dtype=dtype)[1:].reshape(2, 15, 13, 64)
    assert view.is_contiguous() and view.data_ptr() % 16
    assert not vector_instance(dtype, 64, view.data_ptr())
    # a channel row too large for the vector instance's shared memory
    assert not vector_instance(dtype, 32768 // dtype.itemsize, 0)


def test_lrn_maxpool_plan_raises_when_a_row_cannot_fit():
    """The widest channel rows the scalar instance takes: three columns of
    two LRN rows and a pooled column within 227 KB."""
    for c, itemsize in ((8298, 4), (16597, 2)):
        assert lrn_maxpool_plan(1, 8, 8, c, itemsize, False, NUM_SMS)[-1] \
            <= SHARED_BYTES_MAX
        with pytest.raises(ValueError):
            lrn_maxpool_plan(1, 8, 8, c + 1, itemsize, False, NUM_SMS)
