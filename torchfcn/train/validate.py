"""In-training validation of the port (``tpufcn/train/validate.py``): the
Caffe TEST-phase analog.

A validator is a callable ``model -> {metric: float}`` that
``Trainer.fit`` runs every ``cfg.eval_every`` steps, passing its live model
in eval mode under the policy's precision; the best-scoring snapshot is kept
in ``<snapshot_dir>/best``.  Validators for the two head families: detection
mAP under the full serving pipeline (preprocess -> forward -> decode -> NMS
-> rescale, through a ``Detector``) and segmentation mean-IoU (through a
``Segmenter``), each built once and serving the model it is given, with its
own parameters: nothing is copied or cast per call.

Held-out sets come from record shards and VOC manifests (decoded by the
port's ``imageio.imread`` and resized by ``raster.resize_linear_u8``, cv2's
INTER_LINEAR), from detection and mask manifests (``imread`` and
``resize`` from the caller), or are composed on the device by the port's
``DeviceCompositePipeline``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchfcn.core.config import DetectorConfig
from torchfcn.data.imageio import imread_or_none
from torchfcn.data.manifest import bgr2gray_u8, need_decoder, \
    read_detection_manifest, read_mask_manifest, read_voc_manifest
from torchfcn.data.raster import resize_linear_u8, resize_nearest_u8
from torchfcn.train.evaluate import evaluate_detections, \
    evaluate_segmentation

Validator = Callable[[torch.nn.Module], Dict[str, float]]


def score_detection(det, images, gts, num_classes: int, chunk: int = 32,
                    iou_thresh: float = 0.5) -> Tuple[float, int]:
    """mAP@``iou_thresh`` of a Detector over ``images`` (N, H, W, 3), numpy
    or a tensor, against ``gts`` [per image (corner boxes, labels)]; also
    returns the total detection count.  The images go in chunks of
    ``chunk``; the last chunk is not padded (the JAX package pads it only
    to spare a recompile)."""
    dets_all: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    n_det = 0
    for i in range(0, images.shape[0], chunk):
        for items in det(images[i:i + chunk]).to_lists():
            boxes = np.asarray([b for b, _, _ in items],
                               np.float64).reshape(-1, 4)
            labels = np.asarray([l for _, l, _ in items], np.int64)
            scores = np.asarray([c for _, _, c in items], np.float64)
            dets_all.append((boxes, labels, scores))
            n_det += len(items)
    ev = evaluate_detections(gts, dets_all, num_classes=num_classes,
                             iou_thresh=iou_thresh)
    return float(ev["mAP"]), n_det


def detection_validator(model_name: str, images,
                        gts: Sequence[Tuple[np.ndarray, np.ndarray]],
                        model_kwargs: Optional[dict] = None,
                        chunk: int = 32,
                        iou_thresh: float = 0.5,
                        max_candidates: int = 128,
                        config: Optional[DetectorConfig] = None
                        ) -> Validator:
    """Validator: held-out mAP under the full serving pipeline.

    ``gts``: per image (corner boxes, labels) with labels 0-based
    foreground ids (the Detector's output convention).  The Detector is
    built on the first call around the model it is given, which computes
    as its own dtypes and the caller's precision scope say (the Trainer
    opens its policy's); ``model_kwargs`` (a ``num_classes``) set its
    decode grid, or ``config`` sets the grid and the NMS settings (for a
    net trained at another size than its spec's)."""
    state = {}

    def validate(model) -> Dict[str, float]:
        from torchfcn.serve.detector import Detector
        if "det" not in state:
            state["det"] = Detector(model_name, config=config,
                                    max_candidates=max_candidates,
                                    model_kwargs=dict(model_kwargs or {}),
                                    model=model)
        det = state["det"]
        det.model = model
        m, n_det = score_detection(det, images, gts, det.num_fg,
                                   chunk=chunk, iou_thresh=iou_thresh)
        return {"mAP": round(m, 4), "n_det": n_det}

    return validate


def seg_validator(model_name: str, images, masks: np.ndarray,
                  num_classes: Optional[int] = None, chunk: int = 32
                  ) -> Validator:
    """Validator: held-out mean-IoU and pixel accuracy for the seg families.
    ``images`` (N, H, W, 3) at the net's size (the Segmenter does not
    resize; the JAX package resizes to it); ``masks`` (N, H, W) int label
    maps, class 0 background (compositor convention: mask pixel = label +
    1)."""
    from torchfcn.models import get_spec
    classes = num_classes or get_spec(model_name).grid.num_classes
    state = {}

    def validate(model) -> Dict[str, float]:
        from torchfcn.serve.segment import Segmenter
        if "seg" not in state:
            state["seg"] = Segmenter(model_name, model=model)
        seg = state["seg"]
        seg.model = model
        preds = [seg(images[i:i + chunk]).cpu().numpy()
                 for i in range(0, images.shape[0], chunk)]
        res = evaluate_segmentation(list(masks), list(np.concatenate(preds)),
                                    num_classes=classes)
        return {"mIoU": round(float(res["mean_iou"]), 4),
                "pixel_accuracy": round(float(res["pixel_accuracy"]), 4)}

    return validate


def _resize_with_boxes(img: np.ndarray, rects_xywh, hw: Tuple[int, int],
                       resize: Optional[Callable]):
    """Resize to the net's size, scaling xywh rects to corner boxes (mAP
    is scale-invariant when GT and image scale together)."""
    H, W = hw
    sy, sx = H / img.shape[0], W / img.shape[1]
    if img.shape[:2] != (H, W):
        img = need_decoder(resize, "a held-out set")(img, (W, H))
    r = np.asarray(rects_xywh, np.float64).reshape(-1, 4)
    corners = np.stack([r[:, 0] * sx, r[:, 1] * sy,
                        (r[:, 0] + r[:, 2]) * sx,
                        (r[:, 1] + r[:, 3]) * sy], axis=1)
    return img, corners


def val_set_from_records(prefix: str, hw: Tuple[int, int],
                         limit: Optional[int] = None):
    """Held-out detection set from record shards: -> (images (N, H, W, 3) u8,
    gts [per image (corners, labels)])."""
    from torchfcn.data.records import RecordReader
    r = RecordReader(prefix)
    n = len(r) if limit is None else min(limit, len(r))
    images, gts = [], []
    for i in range(n):
        rec = r.read(i)
        img, corners = _resize_with_boxes(rec["image"], rec["rects"], hw,
                                          resize_linear_u8)
        images.append(img)
        gts.append((corners, np.asarray(rec["labels"], np.int64)))
    r.close()
    return np.stack(images), gts


def _samples_to_val_set(samples, hw: Tuple[int, int], src: str,
                        imread: Callable, resize: Optional[Callable]):
    """Images of ``samples`` (``imread(path)`` a BGR uint8 array or None,
    skipped) at the net's size, and their boxes as corners."""
    images, gts = [], []
    for s in samples:
        img = imread(s.image_path)
        if img is None:
            continue
        img, corners = _resize_with_boxes(img, s.rects, hw, resize)
        images.append(img)
        gts.append((corners, np.asarray(s.labels, np.int64)))
    if not images:
        raise ValueError(f"no readable images in {src}")
    return np.stack(images), gts


def val_set_from_manifest(path: str, hw: Tuple[int, int],
                          limit: Optional[int] = None,
                          imread: Optional[Callable] = None,
                          resize: Optional[Callable] = None):
    """Held-out detection set from a ``path x y w h label`` manifest
    (1-based labels): -> (images (N, H, W, 3) u8, gts [per image
    (corners, labels)]).  ``imread(path)`` gives a BGR uint8 array or None;
    ``resize(img, (W, H))`` brings it to the net's size."""
    imread = need_decoder(imread, "val_set_from_manifest")
    return _samples_to_val_set(read_detection_manifest(path)[:limit], hw,
                               path, imread, resize)


def val_set_from_voc(path: str, hw: Tuple[int, int],
                     limit: Optional[int] = None):
    """Held-out detection set from a VOC converter manifest (comma-grouped
    boxes, 0-based labels: ``cli voc``'s output)."""
    return _samples_to_val_set(read_voc_manifest(path)[:limit], hw, path,
                               imread_or_none, resize_linear_u8)


def seg_val_set_from_manifest(path: str, hw: Tuple[int, int],
                              limit: Optional[int] = None,
                              label_map: Optional[dict] = None,
                              imread: Optional[Callable] = None,
                              resize: Optional[Callable] = None):
    """Held-out seg set from a mask manifest (``img mask label x y w h``
    stride-2 records): -> (images (N, H, W, 3) u8, masks (N, H, W) i32 with
    mask pixel = class id, 0 background).  Masks read as gray (a 3-channel
    mask through cv's BGR2GRAY) and resize by nearest neighbour."""
    imread = need_decoder(imread, "seg_val_set_from_manifest")
    samples = read_mask_manifest(path, background_offset=1,
                                 label_map=label_map)[:limit]
    H, W = hw
    images, masks = [], []
    for s in samples:
        img, msk = imread(s.image_path), imread(s.mask_path)
        if img is None or msk is None:
            continue
        if msk.ndim == 3:
            msk = bgr2gray_u8(msk)
        if img.shape[:2] != (H, W):
            img = need_decoder(resize, "seg_val_set_from_manifest")(img, (W, H))
        images.append(img)
        m = resize_nearest_u8(msk, (W, H))
        masks.append(np.where(m > 0, s.label, 0).astype(np.int32))
    if not images:
        raise ValueError(f"no readable image/mask pairs in {path}")
    return np.stack(images), np.stack(masks)


def val_set_from_compositor(pipe, n_images: int, batch: int = 32):
    """A held-out set composed by a ``DeviceCompositePipeline`` (give it
    another seed than the training pipeline's): -> (images (N, H, W, 3) u8
    on the pipeline's device, gts [per image (corners, labels)], masks
    (N, H, W) int32 numpy, label + 1 per object pixel)."""
    images, gts, masks = [], [], []
    for i in range(0, n_images, batch):
        b = pipe.batch(min(batch, n_images - i))
        images.append(b["image"])
        masks.append(b["seg"].cpu().numpy())
        rects = b["rects"].cpu().numpy().astype(np.float64)
        labels = b["labels"].cpu().numpy().astype(np.int64)
        for r, l, v in zip(rects, labels, b["valid"].cpu().numpy()):
            r = r[v]
            gts.append((np.stack([r[:, 0], r[:, 1], r[:, 0] + r[:, 2],
                                  r[:, 1] + r[:, 3]], axis=1), l[v]))
    return torch.cat(images), gts, np.concatenate(masks)
