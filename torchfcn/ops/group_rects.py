"""groupRectangles box-grouping NMS (``cv::groupRectangles``), plain PyTorch.

Counterpart of ``tpufcn/ops/group_rects.py`` and the plain version of the
CUDA kernel (``torchfcn/ops/cuda/group_rects.py``).  Over a fixed-capacity,
batched candidate set (M instances of N candidates):

1. round the rects to integers (half to even, OpenCV's ``cvRound``);
2. cluster them into the connected components of ``SimilarRects``;
3. average each cluster, rounding the integer mean half to even exactly;
4. keep clusters with more than ``group_threshold`` members;
5. suppress a kept cluster that lies inside a bigger kept one with more
   votes (``n2 > max(3, n1) || n1 < 3``).

Results stay in root-index slots: a cluster's slot is its smallest member
index.  As in the reference, corner boxes ``(x1, y1, x2, y2)`` are read as
OpenCV's ``(x, y, w, h)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GroupedRects(NamedTuple):
    rects: torch.Tensor    # (M, N, 4) float32 cluster means (slot = root index)
    weights: torch.Tensor  # (M, N) int32 member counts
    valid: torch.Tensor    # (M, N) bool surviving clusters


class Detections(NamedTuple):
    boxes: torch.Tensor       # (M, N, 4) corner boxes (x1, y1, x2, y2)
    confidence: torch.Tensor  # (M, N) float32 log(votes)
    valid: torch.Tensor       # (M, N) bool


def _similar(r: torch.Tensor, valid: torch.Tensor, eps: float) -> torch.Tensor:
    """(M, N, N) SimilarRects adjacency over (x, y, w, h)-read rows."""
    x, y, w, h = r.unbind(-1)
    xw, yh = x + w, y + h
    delta = (eps * 0.5) * (torch.minimum(w[:, :, None], w[:, None, :])
                           + torch.minimum(h[:, :, None], h[:, None, :]))

    def close(a):
        return (a[:, :, None] - a[:, None, :]).abs() <= delta

    return (close(x) & close(y) & close(xw) & close(yh)
            & valid[:, :, None] & valid[:, None, :])


def _component_labels(adj: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(M, N) int64 labels: each component's smallest member index, by the
    reflexive transitive closure (repeated 0/1 squaring, at most
    ceil(log2(N - 1)) times, until it stops changing), over the instances
    with a valid candidate.  Invalid rows keep their own index."""
    n = adj.shape[-1]
    idx = torch.arange(n, device=adj.device)
    labels = idx.expand(valid.shape).clone()
    some = valid.any(dim=-1)
    a = (adj[some] | torch.eye(n, dtype=torch.bool, device=adj.device)
         ).float()
    for _ in range(max(1, math.ceil(math.log2(max(n - 1, 2))))):
        closed = (a @ a > 0).float()
        if torch.equal(closed, a):
            break
        a = closed
    labels[some] = torch.where(a > 0, idx, n).amin(dim=-1)
    return torch.where(valid, labels, idx)


def _div_round_half_even(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact integer s / c (c > 0), rounded half to even."""
    q = torch.div(s, c, rounding_mode="floor")
    twice_r = 2 * (s - q * c)                  # 0 <= r < c
    up = (twice_r > c) | ((twice_r == c) & (q % 2 == 1))
    return q + up.long()


def group_rectangles(rects: torch.Tensor,
                     valid: torch.Tensor,
                     group_threshold: int = 3,
                     eps: float = 0.2) -> GroupedRects:
    """Batched groupRectangles.

    Args:
      rects: (M, N, 4) candidate boxes, read as ``(x, y, w, h)``.
      valid: (M, N) bool candidate mask.
      group_threshold: keep clusters with count > group_threshold.
      eps: similarity tolerance.
    """
    m, n, _ = rects.shape
    r = torch.round(rects.float())
    valid = valid.bool()
    labels = _component_labels(_similar(r, valid, eps), valid)

    # cluster sums and counts in exact integers, scattered to the root slot
    ri = r.long() * valid[..., None]
    sums = torch.zeros((m, n, 4), dtype=torch.long, device=rects.device)
    sums.scatter_add_(1, labels[..., None].expand(m, n, 4), ri)
    counts = torch.zeros((m, n), dtype=torch.long, device=rects.device)
    counts.scatter_add_(1, labels, valid.long())
    means = _div_round_half_even(sums, counts.clamp(min=1)[..., None]).float()

    survive = counts > group_threshold
    x, y, w, h = means.unbind(-1)
    dx, dy = torch.round(w * eps), torch.round(h * eps)
    # row i is the candidate for suppression, column j the bigger cluster
    inside = ((x[:, :, None] >= (x - dx)[:, None, :])
              & (y[:, :, None] >= (y - dy)[:, None, :])
              & ((x + w)[:, :, None] <= (x + w + dx)[:, None, :])
              & ((y + h)[:, :, None] <= (y + h + dy)[:, None, :]))
    n1, n2 = counts[:, :, None], counts[:, None, :]
    votes = (n2 > n1.clamp(min=3)) | (n1 < 3)
    not_self = ~torch.eye(n, dtype=torch.bool, device=rects.device)
    suppressed = (inside & votes & survive[:, None, :] & not_self).any(dim=-1)

    ok = survive & ~suppressed
    return GroupedRects(
        rects=torch.where(ok[..., None], means, 0.0),
        weights=torch.where(ok, counts, 0).int(),
        valid=ok,
    )


def _detections(g: GroupedRects, min_height: int) -> Detections:
    """Height filter (``rect[3] - rect[1] >= min_height``) and
    confidence = log(votes), rounded once from float64 so that it is the
    same float32 on every device."""
    ok = g.valid & ((g.rects[..., 3] - g.rects[..., 1]) >= min_height)
    conf = torch.log(g.weights.clamp(min=1).double()).float()
    return Detections(boxes=g.rects, confidence=torch.where(ok, conf, 0.0),
                      valid=ok)


def vote_boxes(propose_boxes: torch.Tensor,
               valid: torch.Tensor,
               group_threshold: int = 3,
               eps: float = 0.2,
               min_height: int = 20) -> Detections:
    """Reference ``vote_boxes`` (fcn_object_detector.py:337-351) on one
    (N, 4) candidate set, plain PyTorch."""
    g = group_rectangles(propose_boxes[None], valid[None],
                         group_threshold, eps)
    return Detections(*(t[0] for t in _detections(g, min_height)))


def vote_boxes_batched(propose_boxes: torch.Tensor,
                       valid: torch.Tensor,
                       group_threshold: int = 3,
                       eps: float = 0.2,
                       min_height: int = 20) -> Detections:
    """``vote_boxes`` over (M, K, 4) / (M, K) candidates.  CUDA tensors go
    through the groupRectangles kernel, CPU tensors through the plain
    version above."""
    # imported here: the kernel's wrapper imports this module for its plain
    # version
    from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
    g = group_rectangles_cuda(propose_boxes.float().contiguous(),
                              valid.contiguous(), group_threshold, eps)
    return _detections(g, min_height)
