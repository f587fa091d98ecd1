"""The serving result of the port's Detector, in a module of its own so
that a loaded export (``torchfcn.serve.export.load_exported``) needs
neither the model zoo nor the Detector."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DetectionResult(NamedTuple):
    """Fixed-capacity per-class detections, frame coordinates.

    boxes: (B, C, K, 4) int32 corner boxes (x1, y1, x2, y2).
    confidence: (B, C, K) float32 log-votes (reference conf = log(weight)).
    valid: (B, C, K) bool.
    """

    boxes: torch.Tensor
    confidence: torch.Tensor
    valid: torch.Tensor

    def to_lists(self):
        """Host-side: list (per image) of (box, label, conf) tuples."""
        boxes = self.boxes.cpu().numpy()
        conf = self.confidence.cpu().numpy()
        valid = self.valid.cpu().numpy()
        out = []
        for b in range(boxes.shape[0]):
            dets = []
            for c in range(boxes.shape[1]):
                for i in np.nonzero(valid[b, c])[0]:
                    dets.append((boxes[b, c, i].tolist(), int(c),
                                 float(conf[b, c, i])))
            out.append(dets)
        return out
