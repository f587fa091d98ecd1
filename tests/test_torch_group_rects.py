"""torchfcn's plain groupRectangles NMS against tpufcn's two paths (the fused
Pallas kernel in interpret mode and the XLA formulation) and against the
numpy union-find golden.  Integer-valued outputs must match exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpufcn.ops import group_rects as jax_gr
from tpufcn.ops.pallas.group_rects import group_rectangles_pallas
from torchfcn.ops import group_rects as gr
from torchfcn.ops.cuda.group_rects import group_rectangles_cuda

from golden import golden_group_rectangles, golden_vote_boxes

torch.set_num_threads(2)


def _clustered(rng, n_clusters, per_cluster, jitter=4.0):
    """Corner boxes jittered around cluster prototypes (decoded-cell-like)."""
    boxes = []
    for _ in range(n_clusters):
        x1, y1 = rng.uniform(0, 300, 2)
        x2, y2 = x1 + rng.uniform(60, 140), y1 + rng.uniform(60, 140)
        for _ in range(per_cluster):
            boxes.append([x1 + rng.normal(0, jitter), y1 + rng.normal(0, jitter),
                          x2 + rng.normal(0, jitter), y2 + rng.normal(0, jitter)])
    return np.asarray(boxes, np.float32).reshape(-1, 4)


def _instances(rng, b, n):
    """b instances: clusters, then random singletons, then padding."""
    rects = np.zeros((b, n, 4), np.float32)
    valid = np.zeros((b, n), bool)
    for i in range(b):
        boxes = _clustered(rng, int(rng.integers(1, 6)),
                           int(rng.integers(2, 12)))
        noise = rng.uniform(-50, 450, (int(rng.integers(0, 20)), 4))
        boxes = np.concatenate([boxes, noise])[:n]
        boxes = boxes[rng.permutation(len(boxes))]
        rects[i, :len(boxes)] = boxes
        valid[i, :len(boxes)] = True
    return rects, valid


def _items(rects, weights):
    return sorted(tuple(map(float, r)) + (float(w),)
                  for r, w in zip(rects, weights))


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("b", [3, 4, 16])
def test_plain_matches_pallas_and_xla(rng, b, n):
    rects, valid = _instances(rng, b, n)
    got = gr.group_rectangles(torch.from_numpy(rects),
                              torch.from_numpy(valid), 3, 0.2)
    pallas = group_rectangles_pallas(jnp.asarray(rects), jnp.asarray(valid),
                                     group_threshold=3, eps=0.2,
                                     interpret=True)
    for field in ("rects", "weights", "valid"):
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(pallas, field))), field
    for i in range(b):
        xla = jax_gr.group_rectangles(jnp.asarray(rects[i]),
                                      jnp.asarray(valid[i]), 3, 0.2)
        for field in ("rects", "weights", "valid"):
            assert np.array_equal(getattr(got, field)[i].numpy(),
                                  np.asarray(getattr(xla, field))), \
                f"instance {i} {field}"


def test_plain_matches_golden(rng):
    cap = 64
    for trial in range(8):
        boxes = _clustered(rng, int(rng.integers(1, 4)),
                           int(rng.integers(2, 9)))
        if trial % 2:   # mostly-singleton random boxes
            boxes = rng.uniform(0, 400, (int(rng.integers(1, cap)), 4)
                                ).astype(np.float32)
        n = len(boxes)
        padded = np.zeros((1, cap, 4), np.float32)
        padded[0, :n] = boxes
        got = gr.group_rectangles(torch.from_numpy(padded),
                                  torch.arange(cap)[None] < n, 3, 0.2)
        want_rects, want_w = golden_group_rectangles(boxes, 3, 0.2)
        v = got.valid[0]
        assert _items(got.rects[0][v].numpy(), got.weights[0][v].numpy()) \
            == _items(want_rects, want_w), f"trial {trial}"


def test_vote_boxes_height_filter_and_confidence(rng):
    boxes = _clustered(rng, 3, 6)
    boxes[:6, 3] = boxes[:6, 1] + 12.0          # one short cluster
    det = gr.vote_boxes(torch.from_numpy(boxes),
                        torch.ones(len(boxes), dtype=torch.bool), 3, 0.2, 20)
    want = sorted(golden_vote_boxes(boxes, 3, 0.2, 20))
    v = det.valid
    got = sorted(det.boxes[v].tolist())
    assert got == [w[:4] for w in want]
    # confidence is log(votes) rounded once to float32
    conf = sorted(det.confidence[v].tolist())
    assert conf == [float(np.float32(w[4])) for w in want]


def test_respects_validity_mask(rng):
    boxes = torch.from_numpy(_clustered(rng, 1, 6))[None]
    full = gr.group_rectangles(boxes, torch.ones(1, 6, dtype=torch.bool))
    mask = torch.arange(6)[None] < 3
    part = gr.group_rectangles(boxes, mask)
    assert int(full.valid.sum()) == 1
    assert int(part.valid.sum()) == 0         # 3 votes is not > 3


def test_empty():
    out = gr.group_rectangles(torch.zeros(2, 8, 4),
                              torch.zeros(2, 8, dtype=torch.bool))
    assert not out.valid.any()
    assert not out.rects.any() and not out.weights.any()


def test_vote_boxes_batched_matches_jax(rng):
    rects, valid = _instances(rng, 6, 128)
    got = gr.vote_boxes_batched(torch.from_numpy(rects),
                                torch.from_numpy(valid), 3, 0.2, 20)
    want = jax_gr.vote_boxes_batched(jnp.asarray(rects), jnp.asarray(valid),
                                     3, 0.2, 20)
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert np.array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    # XLA's CPU float32 log is within 1 ulp of the correctly rounded one
    np.testing.assert_array_max_ulp(got.confidence.numpy(),
                                    np.asarray(want.confidence), maxulp=1)


def test_wrapper_takes_plain_version_on_cpu_only(rng):
    rects, valid = _instances(rng, 2, 128)
    rects, valid = torch.from_numpy(rects), torch.from_numpy(valid)
    before = group_rectangles_cuda.launches
    got = group_rectangles_cuda(rects, valid)
    want = gr.group_rectangles(rects, valid)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert group_rectangles_cuda.launches == before
    with pytest.raises(ValueError):
        group_rectangles_cuda(rects.to("meta"), valid.to("meta"))


def test_means_round_half_to_even():
    s = torch.tensor([5, 7, -5, -7, 6, -6, 3, -3])
    c = torch.tensor([2, 2, 2, 2, 4, 4, 2, 2])
    want = np.rint(s.numpy() / c.numpy()).astype(np.int64)
    assert gr._div_round_half_even(s, c).tolist() == want.tolist()
