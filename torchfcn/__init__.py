"""torchfcn: the PyTorch + CUDA port of tpufcn for NVIDIA Hopper GPUs.

Serving paths of the whole model zoo (``torchfcn.models.names()``): raw BGR
frames -> preprocessing (the GoogLeNet and ResNet-FPN nets normalise raw
frames themselves; the VGG and FCN families take demean + min-max) ->
forward -> grid decode -> stable top-K candidates -> groupRectangles NMS ->
truncating rescale (``torchfcn.serve.detector``), and for FCN-32s
segmentation demean -> forward -> argmax (``torchfcn.serve.segment``).

The hand-written CUDA kernels live in ``torchfcn/csrc`` and are built with
``nvcc`` at first use (``torchfcn.ops.cuda.build``).  Every kernel wrapper
takes its plain PyTorch version for CPU tensors, so the whole package runs
(slowly) on a CPU-only host.  The package imports ``torch`` and never JAX.
"""
from torchfcn.core.config import (  # noqa: F401
    IMAGENET_BGR_MEAN, DetectorConfig, GridConfig)
