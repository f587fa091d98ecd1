"""Detection and segmentation evaluation of the port: a copy of
``tpufcn/train/evaluate.py`` (numpy only; importing it from the JAX package
would run ``tpufcn/train/__init__.py``, which imports JAX).

Per-class PASCAL VOC average precision (the 11-point VOC07 metric and the
all-points area under the curve), greedy IoU matching at a configurable
threshold, and segmentation metrics from a pooled confusion matrix.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def box_iou_corners(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) corner boxes -> (N, M) IoU."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_detections(
        ground_truth: Sequence[Tuple[np.ndarray, np.ndarray]],
        detections: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        num_classes: int,
        iou_thresh: float = 0.5,
        use_07_metric: bool = False) -> Dict[str, object]:
    """Per-class AP + mAP.

    Args:
      ground_truth: per image (boxes (M, 4) corners, labels (M,)).
      detections: per image (boxes (K, 4) corners, labels (K,), scores (K,)).
    """
    aps = {}
    for c in range(num_classes):
        records = []   # (score, image_idx, box)
        npos = 0
        gt_per_img = []
        for i, (gboxes, glabels) in enumerate(ground_truth):
            sel = np.asarray(glabels) == c
            g = np.asarray(gboxes, np.float64).reshape(-1, 4)[sel]
            gt_per_img.append({"boxes": g, "used": np.zeros(len(g), bool)})
            npos += len(g)
        for i, (dboxes, dlabels, dscores) in enumerate(detections):
            sel = np.asarray(dlabels) == c
            for box, s in zip(np.asarray(dboxes).reshape(-1, 4)[sel],
                              np.asarray(dscores).reshape(-1)[sel]):
                records.append((float(s), i, box))
        if npos == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for k, (s, img, box) in enumerate(records):
            gt = gt_per_img[img]
            if len(gt["boxes"]) == 0:
                fp[k] = 1
                continue
            ious = box_iou_corners(box[None], gt["boxes"])[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thresh and not gt["used"][j]:
                tp[k] = 1
                gt["used"][j] = True
            else:
                fp[k] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / npos
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        aps[c] = average_precision(recall, precision, use_07_metric)

    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"ap": aps, "mAP": mean_ap}


def evaluate_segmentation(gt_masks: Sequence[np.ndarray],
                          pred_masks: Sequence[np.ndarray],
                          num_classes: int,
                          ignore_label: int | None = None
                          ) -> Dict[str, object]:
    """Semantic-segmentation metrics from a pooled confusion matrix.

    Scores the FCN seg families (C18/C19) the way mAP scores detection;
    the reference ships no segmentation eval either (SURVEY.md §6), so
    like `evaluate_detections` this is the build's own bar.

    Args:
      gt_masks / pred_masks: per image (H, W) integer label maps,
        class 0 = background (the FCN training convention:
        compositor mask = label + 1).
      ignore_label: optional GT value excluded from scoring (e.g. a
        void/boundary class).

    Returns per-class IoU (classes present in GT or prediction),
    mean IoU over those classes, overall pixel accuracy, and mean
    per-class recall ("mean_class_accuracy"), plus the raw confusion
    matrix (rows = GT class, cols = predicted class).
    """
    C = int(num_classes)
    cm = np.zeros((C, C), np.int64)
    invalid = 0
    for gt, pred in zip(gt_masks, pred_masks):
        g = np.asarray(gt).reshape(-1).astype(np.int64)
        p = np.asarray(pred).reshape(-1).astype(np.int64)
        if g.shape != p.shape:
            raise ValueError(
                f"gt/pred size mismatch: {np.shape(gt)} vs {np.shape(pred)}")
        keep = (g >= 0) & (g < C) & (p >= 0) & (p < C)
        if ignore_label is not None:
            keep &= g != ignore_label
            invalid += int(((g < 0) | (g >= C))[g != ignore_label].sum())
        else:
            invalid += int(((g < 0) | (g >= C)).sum())
        cm += np.bincount(g[keep] * C + p[keep],
                          minlength=C * C).reshape(C, C)
    if invalid:
        # out-of-range GT usually means num_classes is wrong — silently
        # dropping those pixels would inflate every metric
        import warnings
        warnings.warn(
            f"evaluate_segmentation: {invalid} GT pixels outside "
            f"[0, {C}) were excluded — check num_classes",
            stacklevel=2)
    tp = np.diag(cm).astype(np.float64)
    gt_count = cm.sum(axis=1).astype(np.float64)
    pr_count = cm.sum(axis=0).astype(np.float64)
    union = gt_count + pr_count - tp
    present = union > 0
    iou = np.zeros(C)
    np.divide(tp, union, out=iou, where=present)
    total = float(cm.sum())
    seen = gt_count > 0
    return {
        "iou": {c: float(iou[c]) for c in range(C) if present[c]},
        "mean_iou": float(iou[present].mean()) if present.any() else 0.0,
        "pixel_accuracy": float(tp.sum() / total) if total else 0.0,
        "mean_class_accuracy":
            float((tp[seen] / gt_count[seen]).mean()) if seen.any() else 0.0,
        "invalid_gt_pixels": invalid,
        "confusion": cm,
    }


def evaluate_detector(detector, images: Sequence[np.ndarray],
                      ground_truth, num_classes: int,
                      iou_thresh: float = 0.5) -> Dict[str, object]:
    """Run the serve pipeline over images and score against GT."""
    dets = []
    for img in images:
        res = detector(np.asarray(img)[None])
        items = res.to_lists()[0]
        boxes = np.asarray([b for b, _, _ in items], np.float64).reshape(-1, 4)
        labels = np.asarray([l for _, l, _ in items], np.int64)
        scores = np.asarray([c for _, _, c in items], np.float64)
        dets.append((boxes, labels, scores))
    return evaluate_detections(ground_truth, dets, num_classes, iou_thresh)
