"""Serving artifacts: the whole Detector pipeline as a ``torch.export``
program (``tpufcn/serve/export.py`` writes StableHLO).

    art = export_detector(det, batch_size=8)        # bytes
    fn = load_exported(art)                         # callable
    res = fn(params, frames_u8)                     # DetectionResult

The program is ``Detector.forward_fn``'s pipeline (preprocess -> forward ->
grid decode -> top-K -> groupRectangles NMS -> rescale) traced at one batch
size and frame size.  The hand kernels stay in it as the custom ops
``torch.ops.torchfcn.*`` (``torchfcn.ops.cuda``), so a loaded program
launches them on the card and runs their plain versions on the CPU, as the
Detector does.  Weights stay outside the artifact: they are the first call
argument (``Detector.forward_fn()[1]``, or any map of the same names), so
new weights need no new export.  Loading needs only ``torch`` and the op
library, not the model zoo.

A float32 Detector runs with TF32 off (``DTypePolicy.precision``); those
are global switches that the program does not hold, so the artifact
records the policy and the loaded callable enters the same scope.
"""

from __future__ import annotations

import io
import json
from typing import Optional, Tuple

import torch

from torchfcn.serve.result import DetectionResult

_META = "torchfcn_export.json"


class _Program(torch.nn.Module):
    """The pipeline as a module for ``torch.export``: (params, frames) ->
    (boxes, confidence, valid)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, params: dict, frames: torch.Tensor):
        return tuple(self.fn(params, frames))


def export_detector(det, batch_size: int,
                    in_hw: Optional[Tuple[int, int]] = None) -> bytes:
    """Serialize ``det``'s pipeline (``det.forward_fn()``) for uint8 frames
    of (``batch_size``, H, W, 3) on ``det``'s device.

    in_hw: the incoming frame (H, W), by default the net's; the pipeline
    resizes on the device, so another size bakes that resize in.
    """
    fn, params = det.forward_fn()
    g = det.grid
    h, w = in_hw or (g.im_height, g.im_width)
    frames = torch.zeros((batch_size, h, w, 3), dtype=torch.uint8,
                         device=det.device)
    with torch.no_grad():
        program = torch.export.export(_Program(fn), (params, frames))
    program.example_inputs = None     # the weights stay out of the artifact
    meta = dict(model=det.config.model, batch=batch_size, in_hw=[h, w],
                exact=det.policy.exact, device=det.device.type)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def load_exported(artifact: bytes):
    """``fn(params, frames) -> DetectionResult`` from ``export_detector``'s
    bytes, run without autograd and, for a float32 Detector's artifact,
    with TF32 off as the Detector ran it."""
    import torchfcn.ops.cuda.group_rects  # noqa: F401  (registers the ops)
    import torchfcn.ops.cuda.lrn  # noqa: F401
    import torchfcn.ops.cuda.lrn_pool  # noqa: F401
    import torchfcn.ops.cuda.stem  # noqa: F401
    from torchfcn.core.dtypes import float32_exact

    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(artifact), extra_files=extra)
    exact = json.loads(extra[_META])["exact"]
    module = program.module()

    def fn(params: dict, frames: torch.Tensor) -> DetectionResult:
        scope = float32_exact() if exact else torch.no_grad()
        with torch.no_grad(), scope:
            return DetectionResult(*module(params, frames))
    return fn
