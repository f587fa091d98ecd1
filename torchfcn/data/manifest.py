"""Dataset manifests of the port: a copy of the sample records, the
manifest readers and writers and the label-map snapshot helpers of
``tpufcn/data/manifest.py`` (numpy only).  Copied and not imported, because
importing ``tpufcn.data.manifest`` runs ``tpufcn/data/__init__.py``, which
imports JAX and ``cv2``.

Formats:

* detection: ``path x y w h label`` per line, 1-based labels;
* mask: ``img_path mask_path label x y w h`` on every *other* line (the
  reference reader strides by 2), labels remapped to contiguous ids via
  unique-inverse, +1 when background is class 0;
* voc: ``img_path,x y w h label,x y w h label,...``, 0-based labels (the
  VOC converter's, ``torchfcn.data.voc``);
* label names: ``idx name`` (written) or ``idx _ name`` (read too).

Manifests name image files; ``torchfcn.data.imageio.imread`` decodes the
JPEGs and PNGs they name without ``cv2``.  The readers that decode (the
validators' held-out sets, ``DeviceCompositePipeline.from_samples``) still
take ``imread`` (and ``resize``) from their caller (``need_decoder``);
``bgr2gray_u8`` reads a mask decoded in colour.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DetectionSample:
    image_path: str
    rects: np.ndarray        # (M, 4) int (x, y, w, h)
    labels: np.ndarray       # (M,) int


@dataclasses.dataclass
class MaskSample:
    image_path: str
    mask_path: str
    label: int
    rect: np.ndarray         # (4,) int


def read_detection_manifest(path: str,
                            one_based_labels: bool = True) -> List[DetectionSample]:
    out = []
    for line in _lines(path):
        vals = line.split()
        rect = np.array([int(float(v)) for v in vals[1:5]], np.int32)
        label = int(vals[5]) - (1 if one_based_labels else 0)
        out.append(DetectionSample(vals[0], rect[None, :],
                                   np.array([label], np.int32)))
    return out


def detection_line(image_path: str, rect, label,
                   one_based_labels: bool = True) -> str:
    """One ``path x y w h label`` detection-manifest line, the inverse of
    ``read_detection_manifest`` (which subtracts the one-based offset this
    adds)."""
    x, y, w, h = [int(v) for v in rect]
    return (f"{image_path} {x} {y} {w} {h} "
            f"{int(label) + (1 if one_based_labels else 0)}")


def read_mask_manifest(path: str,
                       line_stride: int = 2,
                       background_offset: int = 0,
                       snapshot_label_manifest: Optional[str] = None,
                       label_map: Optional[Dict[int, int]] = None,
                       ) -> List[MaskSample]:
    """The compositor dataset: image+mask+label+rect records.

    ``line_stride=2`` mirrors the reference reader; ``background_offset=1``
    reproduces the FCN variant's shift so 0 stays background.

    ``label_map`` (raw manifest label -> final class id) pins the class
    ids to a TRAINING run's mapping (see `read_label_map_snapshot`).
    The snapshot ids are ONE-based (the reference's convention and the
    seg-class id space — compositor masks store label+1), so when
    ``label_map`` is given it fully determines the returned ids and
    ``background_offset`` is NOT applied on top.  Without it labels are
    densified per manifest — fine for training, but an eval manifest
    missing some training class would silently shift every id.
    """
    # stride over the RAW file like the reference reader
    # (data_argumentation_layer.py read_data_from_textfile2: xrange
    # step 2 over open().readlines()) — the skipped lines may be blank
    # separators, and compacting blanks first would silently drop every
    # second record of such a manifest
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    raw = []
    for i in range(0, len(lines), line_stride):
        v = lines[i].split()
        if not v:
            if all(not ln.strip() for ln in lines[i:]):
                break   # trailing blank lines at EOF
            raise ValueError(
                f"{path}:{i + 1}: blank record line (with "
                f"line_stride={line_stride} every {line_stride}th line "
                "must hold an `img mask label x y w h` record)")
        rect = np.array([int(float(x)) for x in v[3:7]], np.int32)
        raw.append((v[0], v[1], int(v[2]), rect))

    labels = np.array([r[2] for r in raw])
    if label_map is not None:
        unknown = sorted(set(int(l) for l in labels) - set(label_map))
        if unknown:
            raise ValueError(
                f"manifest labels {unknown} are missing from the "
                "label-map snapshot")
        inv = np.array([label_map[int(l)] for l in labels])
        return [MaskSample(p, m, int(l), r)
                for (p, m, _, r), l in zip(raw, inv)]
    uniq, inv = np.unique(labels, return_inverse=True)
    inv = inv + background_offset

    if snapshot_label_manifest:
        # reference writes a per-run label manifest snapshot with
        # ONE-based ids regardless of layer variant
        # (data_argumentation_layer.py:182-188 ``n_label = index + 1``)
        # — that is the seg-class convention (compositor masks store
        # label+1), which is exactly what eval needs the map for, so
        # the snapshot is 1-based independent of background_offset
        os.makedirs(os.path.dirname(snapshot_label_manifest) or ".",
                    exist_ok=True)
        with open(snapshot_label_manifest, "w") as f:
            for index, old in enumerate(uniq):
                f.write(f"{index + 1} {int(old)}\n")

    return [MaskSample(p, m, int(l), r)
            for (p, m, _, r), l in zip(raw, inv)]


def snapshot_label_path(directory: str = "snapshots/labels") -> str:
    return os.path.join(
        directory, "labels_" + time.strftime("%Y%m%d%H%M%S") + ".txt")


def read_label_map_snapshot(path: str) -> Dict[int, int]:
    """Read a label-manifest snapshot written by `read_mask_manifest`
    (lines of "final_id raw_label") into {raw_label: final_id} — pass
    as `label_map=` so eval manifests share the training run's ids."""
    out: Dict[int, int] = {}
    for ln in _lines(path):
        new_id, old = ln.split()
        out[int(old)] = int(new_id)
    return out


def read_voc_manifest(path: str) -> List[DetectionSample]:
    """Samples of a VOC converter manifest; groups that are not five values
    are skipped, and so are lines with no box."""
    out = []
    for line in _lines(path):
        parts = line.split(",")
        rects, labels = [], []
        for grp in parts[1:]:
            v = grp.split()
            if len(v) != 5:
                continue
            rects.append([int(float(x)) for x in v[:4]])
            labels.append(int(v[4]))
        if rects:
            out.append(DetectionSample(
                parts[0], np.asarray(rects, np.int32),
                np.asarray(labels, np.int32)))
    return out


def write_voc_manifest(path: str, samples: Sequence[DetectionSample]) -> None:
    with open(path, "w") as f:
        for s in samples:
            groups = ",".join(
                f"{int(r[0])} {int(r[1])} {int(r[2])} {int(r[3])} {int(l)}"
                for r, l in zip(s.rects, s.labels))
            f.write(f"{s.image_path},{groups}\n")


def write_label_names(path: str, names: Sequence[str]) -> None:
    with open(path, "w") as f:
        for i, n in enumerate(names):
            f.write(f"{i} {n}\n")


def need_decoder(fn, what: str):
    """``fn``, or a clear error where the caller gave no decoder."""
    if fn is None:
        raise ValueError(
            f"{what} needs a decoder from the caller (imread=, and resize= "
            f"where sizes differ): the port does not import cv2")
    return fn


def bgr2gray_u8(img: np.ndarray) -> np.ndarray:
    """cv.cvtColor(img, COLOR_BGR2GRAY) of a uint8 BGR image, in cv2 5.0's
    fixed-point arithmetic (15 fractional bits, rounded); equal on every
    colour."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(
        np.uint8)


def read_label_names(path: str) -> List[str]:
    """Class names of a label manifest, one per line: ``idx name`` or
    ``idx _ name`` (``tpufcn/data/manifest.py:187``)."""
    return [line.split()[-1] for line in _lines(path)]


def _lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]
