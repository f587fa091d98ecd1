"""torchfcn's grid-label encoder, box IoU and losses against tpufcn's on the
same seeded inputs: the encoder exactly, ``scaled_iou_xywh`` to 1e-6 and
the losses to rtol 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpufcn.core.config import GridConfig as JGridConfig
from tpufcn.ops import boxes as jboxes
from tpufcn.ops import grid_codec as jcodec
from tpufcn.train import losses as jlosses
from torchfcn.core.config import GridConfig
from torchfcn.ops import boxes as tboxes
from torchfcn.ops import grid_codec as tcodec
from torchfcn.train import losses as tlosses

GRIDS = [(64, 64, 8, 3), (96, 64, 16, 2)]


def _hard_rects(rng, b, m, w, h):
    """GT rects that overlap each other, sit on cell boundaries, leave the
    image or are degenerate, with valid flags and labels (some outside
    the classes)."""
    xy = rng.uniform(-8, max(w, h), (b, m, 2))
    wh = rng.uniform(2, max(w, h) / 2, (b, m, 2))
    rects = np.concatenate([xy, wh], -1).astype(np.float32)
    rects[:, 0] = [8.0, 16.0, 16.0, 8.0]                   # on cell edges
    rects[:, 1] = rects[:, 0] + [4.0, 0.0, 0.0, 4.0]       # overlaps rect 0
    rects[:, 2] = [0.0, 0.0, 0.0, 12.0]                    # zero width
    rects[:, 3] = [float(w - 8), float(h - 8), 24.0, 24.0]  # past the edge
    return rects


@pytest.mark.parametrize("w,h,stride,classes", GRIDS)
def test_encoder_matches_jax_exactly(w, h, stride, classes):
    rng = np.random.default_rng(stride)
    b, m = 3, 9
    rects = _hard_rects(rng, b, m, w, h)
    labels = rng.integers(-1, classes + 1, (b, m)).astype(np.int32)
    labels[:, :2] = [0, classes - 1]   # rect 1 overwrites rect 0's cells
    valid = rng.random((b, m)) < 0.75
    valid[:, :2] = True
    want = jcodec.encode_grid_labels_batch(
        rects, labels, valid, JGridConfig(w, h, stride, classes))
    got = tcodec.encode_grid_labels_batch(
        torch.from_numpy(rects), torch.from_numpy(labels),
        torch.from_numpy(valid), GridConfig(w, h, stride, classes))
    for field in tcodec.GridLabels._fields:
        a, e = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == e.shape, field
        np.testing.assert_array_equal(a, e, err_msg=field)
    # the last writer wins: rect 1 covers cells that rect 0 also covers
    assert got.coverage[..., classes - 1].sum() > 0
    one = tcodec.encode_grid_labels(
        torch.from_numpy(rects[0]), torch.from_numpy(labels[0]),
        torch.from_numpy(valid[0]), GridConfig(w, h, stride, classes))
    for field in tcodec.GridLabels._fields:
        assert torch.equal(getattr(one, field), getattr(got, field)[0])


def test_grid_cells_match_jax():
    grid = (96, 64, 16, 2)
    np.testing.assert_array_equal(
        tcodec.grid_cells(GridConfig(*grid)).numpy(),
        np.asarray(jcodec.grid_cells(JGridConfig(*grid))))


def test_scaled_iou_matches_jax():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(-20, 60, (200, 2)),
                        rng.uniform(0.5, 40, (200, 2))], -1).astype(np.float32)
    b = np.concatenate([rng.uniform(-20, 60, (200, 2)),
                        rng.uniform(0.5, 40, (200, 2))], -1).astype(np.float32)
    b[:50] = a[:50] + rng.normal(0, 2, (50, 4)).astype(np.float32)  # overlap
    b[50:60, :2] = a[50:60, :2] + a[50:60, 2:]            # touching corners
    for fn in ("iou_xywh", "scaled_iou_xywh"):
        want = np.asarray(getattr(jboxes, fn)(a[:, None], b[None]))
        got = getattr(tboxes, fn)(torch.from_numpy(a)[:, None],
                                  torch.from_numpy(b)[None]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert (want > 0).sum() > 50


def _outputs(rng, b, gh, gw, c, hw=None):
    out = {"coverage": rng.random((b, gh, gw, c), dtype=np.float32),
           "bboxes": rng.normal(0, 10, (b, gh, gw, 4 * c)).astype(np.float32)}
    if hw:
        out["seg"] = rng.normal(0, 3, (b, hw, hw, c)).astype(np.float32)
    return out


def _labels(rng, b, grid):
    xy = rng.uniform(0, grid[0] * 0.7, (b, 5, 2))
    wh = rng.uniform(6, grid[0] * 0.5, (b, 5, 2))
    rects = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = rng.integers(0, grid[3], (b, 5)).astype(np.int32)
    valid = rng.random((b, 5)) < 0.8
    return (jcodec.encode_grid_labels_batch(rects, labels, valid,
                                            JGridConfig(*grid)),
            tcodec.encode_grid_labels_batch(
                torch.from_numpy(rects), torch.from_numpy(labels),
                torch.from_numpy(valid), GridConfig(*grid)))


def test_elementary_losses_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(0, 3, (4, 5, 6, 7)).astype(np.float32)
    b = rng.normal(0, 3, (4, 5, 6, 7)).astype(np.float32)
    for fn in ("l1_loss_caffe", "euclidean_loss_caffe"):
        np.testing.assert_allclose(
            float(getattr(tlosses, fn)(torch.from_numpy(a),
                                       torch.from_numpy(b))),
            float(getattr(jlosses, fn)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6)
    logits = rng.normal(0, 4, (2, 8, 8, 5)).astype(np.float32)
    lab = rng.integers(0, 5, (2, 8, 8)).astype(np.int32)
    lab[0, 0, :3] = [-1, -5, 4]        # indices counted from the last class
    for normalize in (False, True):
        np.testing.assert_allclose(
            float(tlosses.seg_loss(torch.from_numpy(logits),
                                   torch.from_numpy(lab), normalize)),
            float(jlosses.seg_loss(jnp.asarray(logits), jnp.asarray(lab),
                                   normalize)), rtol=1e-6)
    lab[1, 1, 1] = 5                   # outside [-C, C): NaN on both sides
    assert np.isnan(float(jlosses.seg_loss(jnp.asarray(logits),
                                           jnp.asarray(lab))))
    assert np.isnan(float(tlosses.seg_loss(torch.from_numpy(logits),
                                           torch.from_numpy(lab))))


@pytest.mark.parametrize("with_seg", [False, True])
def test_detectnet_loss_matches_jax(with_seg):
    rng = np.random.default_rng(2)
    grid = (64, 64, 8, 3)
    jlab, tlab = _labels(rng, 2, grid)
    out = _outputs(rng, 2, 8, 8, 3, hw=64 if with_seg else None)
    seg = rng.integers(-1, 4, (2, 64, 64)).astype(np.int32) if with_seg \
        else None
    kw = dict(bbox_weight=2.0, coverage_weight=0.5, seg_weight=1.5)
    jt, jm = jlosses.detectnet_loss(
        {k: jnp.asarray(v) for k, v in out.items()}, jlab,
        seg_labels=None if seg is None else jnp.asarray(seg), **kw)
    tt, tm = tlosses.detectnet_loss(
        {k: torch.from_numpy(v) for k, v in out.items()}, tlab,
        seg_labels=None if seg is None else torch.from_numpy(seg), **kw)
    assert sorted(tm) == sorted(jm)
    for key in tm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    if with_seg:
        assert float(tm["seg_invalid_px"]) == float((seg < 0).sum()
                                                    + (seg >= 3).sum()) > 0


def test_detectnet_loss_raises_without_a_matching_term():
    out = {"seg": torch.zeros(1, 8, 8, 3)}
    labels = tcodec.GridLabels(*(torch.zeros(1, 1, 1, 4),) * 5)
    with pytest.raises(ValueError, match="no loss term"):
        tlosses.detectnet_loss(out, labels)
    with pytest.raises(ValueError, match="no loss term"):
        jlosses.detectnet_loss({"seg": jnp.zeros((1, 8, 8, 3))},
                               jcodec.GridLabels(*(jnp.zeros((1, 1, 1, 4)),)
                                                 * 5))
