"""The port's entry point (``__graft_entry__.py::entry``): the
flagship serving pipeline as one function and its arguments.

    fn, (params, frames) = entry()
    result = fn(params, frames)       # DetectionResult on the card

``Detector("googlenet_detectnet", max_candidates=256)`` in bf16 on
``device`` (the card by default; "cpu" runs the kernels' plain versions):
preprocess -> forward -> decode -> top-K -> groupRectangles NMS ->
rescale, with the parameters as an explicit input
(``Detector.forward_fn``), on a zero batch of 8 448x448 uint8 BGR frames.
"""

from __future__ import annotations

import torch

BATCH, NET, K = 8, 448, 256


def entry(device="cuda"):
    from torchfcn.serve.detector import Detector
    det = Detector("googlenet_detectnet", dtype=torch.bfloat16,
                   max_candidates=K, device=device)
    fn, params = det.forward_fn()
    frames = torch.zeros((BATCH, NET, NET, 3), dtype=torch.uint8,
                         device=det.device)
    return fn, (params, frames)
