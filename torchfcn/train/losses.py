"""DetectNet loss graph, Caffe semantics (``tpufcn/train/losses.py``).

The reference states the loss in prototxt (models/train_val.prototxt:
2237-2281, train/fcn_bbox/train_val.prototxt:568-659):

  label side:  bbox-label (*) size-block (*) obj-block
  pred side:   bboxes (*) coverage-block (*) size-block (*) obj-block
  losses:      L1Loss(pred, label) * 2.0          (NVCaffe layer)
             + EuclideanLoss(coverage, coverage-label)
  [fcn_bbox]   + SoftmaxWithLoss(seg, label)       (normalize: false)

with Caffe's normalisations: L1Loss sum / batch, EuclideanLoss sum /
(2 batch), SoftmaxWithLoss with ``normalize: false`` sum / batch.  All in
float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from torchfcn.ops.grid_codec import GridLabels


def l1_loss_caffe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """NVCaffe L1Loss: the sum of absolute differences over the batch
    size."""
    return (pred.float() - target.float()).abs().sum() / pred.shape[0]


def euclidean_loss_caffe(pred: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Caffe EuclideanLoss: the sum of squared differences over twice the
    batch size."""
    d = pred.float() - target.float()
    return (d * d).sum() / (2.0 * pred.shape[0])


def seg_loss(logits: torch.Tensor, label: torch.Tensor,
             normalize: bool = False) -> torch.Tensor:
    """SoftmaxWithLoss over NHWC logits and integer NHW labels: the mean
    over pixels, or with ``normalize=False`` (the reference seg nets) the
    sum over the batch size.  Labels index as the JAX package's
    ``take_along_axis`` does: -C..-1 count from the last class, and a label
    outside [-C, C) gives a NaN loss (``detectnet_loss`` counts the labels
    outside [0, C) in ``seg_invalid_px``)."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    lab = label.long()
    idx = torch.where(lab < 0, lab + c, lab)
    inside = (idx >= 0) & (idx < c)
    picked = torch.gather(logp, -1, torch.where(inside, idx, 0)[..., None])
    nll = torch.where(inside, -picked[..., 0], float("nan"))
    if normalize:
        return nll.mean()
    return nll.sum() / logits.shape[0]


def detectnet_loss(outputs: Dict[str, torch.Tensor],
                   labels: GridLabels,
                   bbox_weight: float = 2.0,
                   coverage_weight: float = 1.0,
                   seg_labels: Optional[torch.Tensor] = None,
                   seg_weight: float = 1.0,
                   seg_normalize: bool = False,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total DetectNet training loss and its terms.

    Args:
      outputs: the model's dict: "coverage" (B, gh, gw, C), "bboxes"
        (B, gh, gw, 4C) and optionally "seg" (B, H, W, C).  Heads a family
        lacks are skipped (FCN-32s has the seg term only).
      labels: batched GridLabels.
      seg_labels: (B, H, W) integer masks for the seg term, or None.
    Raises ValueError when no term matches the outputs.
    """
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(outputs.values())).device)
    metrics: Dict[str, torch.Tensor] = {}
    if "bboxes" in outputs:
        # the masked, normalised Eltwise PROD chains
        label_side = labels.bbox * labels.size * labels.obj
        pred_side = (outputs["bboxes"].float() * labels.coverage_block
                     * labels.size * labels.obj)
        bbox_l = l1_loss_caffe(pred_side, label_side)
        total = total + bbox_weight * bbox_l
        metrics["loss_bbox"] = bbox_l
    if "coverage" in outputs:
        cov_l = euclidean_loss_caffe(outputs["coverage"], labels.coverage)
        total = total + coverage_weight * cov_l
        metrics["loss_coverage"] = cov_l
    if seg_labels is not None and "seg" in outputs:
        s = seg_loss(outputs["seg"], seg_labels, seg_normalize)
        total = total + seg_weight * s
        metrics["loss_seg"] = s
        # count the labels outside the classes (-1 would train the last
        # class with a finite loss), so that a wrong num_classes shows
        c = outputs["seg"].shape[-1]
        lab = seg_labels.long()
        metrics["seg_invalid_px"] = ((lab < 0) | (lab >= c)).sum().float()
    if not metrics:
        raise ValueError(
            f"no loss term matches the model outputs {sorted(outputs)}; "
            "seg-only families need with_seg=True")
    metrics["loss_total"] = total
    return total, metrics
