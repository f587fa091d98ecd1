"""torchfcn: the PyTorch + CUDA port of tpufcn for NVIDIA Hopper GPUs.

Serving path of the GoogLeNet DetectNet family: raw BGR frames -> Power(-127)
shift -> GoogLeNet forward -> grid decode -> stable top-K candidates ->
groupRectangles NMS -> truncating rescale (``torchfcn.serve.detector``).

The hand-written CUDA kernels live in ``torchfcn/csrc`` and are built with
``nvcc`` at first use (``torchfcn.ops.cuda.build``).  Every kernel wrapper
takes its plain PyTorch version for CPU tensors, so the whole package runs
(slowly) on a CPU-only host.  The package imports ``torch`` and never JAX.
"""
