"""Pascal VOC annotations to manifests (``tpufcn/data/voc.py``, the
reference's scripts/voc/create_train_val.py): walks ``Annotations/*.xml``
with the standard library's XML parser and writes the multi-box train and
val manifests in the comma-grouped format, and ``class_label_names.txt``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

from torchfcn.data.manifest import (
    DetectionSample, write_label_names, write_voc_manifest)

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_annotation(xml_path: str
                     ) -> List[Tuple[str, Tuple[int, int, int, int]]]:
    """[(class_name, (x, y, w, h))] of one VOC annotation file."""
    root = ET.parse(xml_path).getroot()
    out = []
    for obj in root.findall("object"):
        name = obj.findtext("name")
        box = obj.find("bndbox")
        if name is None or box is None:
            continue
        xmin = int(float(box.findtext("xmin")))
        ymin = int(float(box.findtext("ymin")))
        xmax = int(float(box.findtext("xmax")))
        ymax = int(float(box.findtext("ymax")))
        out.append((name, (xmin, ymin, xmax - xmin, ymax - ymin)))
    return out


class PascalVOC:
    """A VOC devkit directory -> manifests.  Objects of classes outside
    ``classes`` are skipped; labels are indices into ``classes``."""

    def __init__(self, voc_root: str,
                 classes: Sequence[str] = VOC_CLASSES,
                 img_ext: str = ".jpg"):
        self.voc_root = voc_root
        self.classes = list(classes)
        self.img_ext = img_ext
        self.img_dir = os.path.join(voc_root, "JPEGImages")
        self.ann_dir = os.path.join(voc_root, "Annotations")
        self.set_dir = os.path.join(voc_root, "ImageSets", "Main")

    def convert_split(self, split: str, out_path: str) -> int:
        """ImageSets/Main/<split>.txt -> a manifest; returns its samples."""
        with open(os.path.join(self.set_dir, split + ".txt")) as f:
            ids = [ln.split()[0] for ln in f if ln.strip()]
        samples = []
        for idx in ids:
            ann = os.path.join(self.ann_dir, idx + ".xml")
            if not os.path.isfile(ann):
                continue
            rects, labels = [], []
            for name, rect in parse_annotation(ann):
                if name in self.classes:
                    rects.append(rect)
                    labels.append(self.classes.index(name))
            if rects:
                samples.append(DetectionSample(
                    os.path.join(self.img_dir, idx + self.img_ext),
                    np.asarray(rects, np.int32),
                    np.asarray(labels, np.int32)))
        write_voc_manifest(out_path, samples)
        return len(samples)

    def create(self, out_dir: str = ".") -> None:
        """train.txt, val.txt and class_label_names.txt in ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        self.convert_split("train", os.path.join(out_dir, "train.txt"))
        self.convert_split("val", os.path.join(out_dir, "val.txt"))
        write_label_names(os.path.join(out_dir, "class_label_names.txt"),
                          self.classes)
