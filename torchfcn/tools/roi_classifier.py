"""Per-proposal ROI classification (``tpufcn/tools/roi_classifier.py``).

Mirrors reference scripts/misc/region_cnn_detector.py: crop each
proposed rect, batch-classify, keep proposals whose argmax probability
exceeds a threshold (reference :60-86 uses 0.5).  The classifier is
pluggable; the default is a linear softmax head over the VGG CNN codes
(the reference used a separately-trained CaffeNet — any
``(N, D) codes -> (N, C) probs`` callable drops in).  The codes come from
the card (``CnnCodeExtractor``); the head runs on the host in numpy.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from torchfcn.serve.bus import TimeSynchronizer
from torchfcn.serve.stream import RectsMsg
from torchfcn.tools.features import CnnCodeExtractor


class ROIClassifierNode:
    """Bus node for the reference's (committed-but-disabled) subscribe
    mode (region_cnn_detector.py:57 + callback :87-110): exact-time
    sync over (image, rects) topics, re-classify each proposed rect,
    publish only the proposals the classifier confirms.  Consumes the
    detector node's ``RectsMsg`` corner-point pairs and republishes the
    same message shape with classifier labels/probabilities."""

    def __init__(self, bus,
                 classifier: "ROIClassifier",
                 image_topic: str = "image",
                 rects_topic: str = "/fcn_object_detector/rects",
                 out_topic: str = "/rcnn_detector/rects",
                 queue_size: int = 10):
        self.bus = bus
        self.classifier = classifier
        self.out_topic = out_topic
        TimeSynchronizer(bus, [image_topic, rects_topic], self.callback,
                         queue_size=queue_size)

    def callback(self, image_msg, rects_msg):
        img = np.asarray(image_msg.data)
        m = rects_msg.data
        rects = [(x1, y1, x2 - x1, y2 - y1)
                 for (x1, y1), (x2, y2) in zip(m.points[0::2],
                                               m.points[1::2])]
        results = self.classifier(img, rects)
        pts = [p for rect, _, _ in results
               for p in ((rect[0], rect[1]),
                         (rect[0] + rect[2], rect[1] + rect[3]))]
        self.bus.publish(self.out_topic,
                         RectsMsg(pts, [l for _, l, _ in results],
                                  [pr for _, _, pr in results]),
                         stamp=image_msg.stamp)


def _softmax_head(w: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
    def head(codes):
        logits = codes @ w
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    return head


class ROIClassifier:
    def __init__(self,
                 num_classes: int,
                 extractor: Optional[CnnCodeExtractor] = None,
                 head: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 prob_thresh: float = 0.5,
                 seed: int = 0):
        self.extractor = extractor or CnnCodeExtractor()
        self.prob_thresh = prob_thresh
        if head is None:
            # an UNTRAINED random head: with C classes its near-uniform
            # probs (~1/C) sit below the 0.5 threshold, so every
            # proposal is rejected until fit_head()/a real head is set
            import logging
            logging.getLogger(__name__).warning(
                "ROIClassifier built with a random untrained head; "
                "call fit_head() (or pass head=) before classifying — "
                "the default rejects essentially all proposals")
            rng = np.random.default_rng(seed)
            head = _softmax_head(rng.normal(0, 0.01,
                                            size=(512, num_classes)))
        self.head = head

    def fit_head(self, codes: np.ndarray, labels: np.ndarray,
                 num_classes: int, l2: float = 1e-3):
        """Closed-form ridge one-vs-all head over codes (a practical
        replacement for the reference's offline Caffe fine-tune)."""
        onehot = np.eye(num_classes)[labels]
        a = codes.T @ codes + l2 * np.eye(codes.shape[1])
        self.head = _softmax_head(np.linalg.solve(a, codes.T @ onehot))

    def __call__(self, image: np.ndarray,
                 rects: Sequence[Sequence[int]]
                 ) -> List[Tuple[List[int], int, float]]:
        """Returns [(rect, label, prob)] for proposals above threshold."""
        crops = []
        kept_rects = []
        for r in rects:
            x, y, w, h = [int(v) for v in r]
            x, y = max(x, 0), max(y, 0)
            w = min(w, image.shape[1] - x)
            h = min(h, image.shape[0] - y)
            if w <= 1 or h <= 1:
                continue
            crops.append(image[y:y + h, x:x + w])
            kept_rects.append([x, y, w, h])
        if not crops:
            return []
        probs = self.head(self.extractor(crops))
        out = []
        for rect, p in zip(kept_rects, probs):
            label = int(np.argmax(p))
            if p[label] > self.prob_thresh:
                out.append((rect, label, float(p[label])))
        return out
