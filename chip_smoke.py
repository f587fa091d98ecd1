#!/usr/bin/env python3
"""Smoke run of the torchfcn serving and training paths on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero.
TF32 is off throughout (but for the TF32 trap of phase 8), so the float32
plain versions are full float32.

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: compile ``torchfcn/csrc`` with nvcc for sm_90a, one nvcc per
   source, in parallel;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the serving paths' shapes, with both times: device time per call
   (``busy_ms``: every kernel and copy of the call, the wrapper's own
   included, under torch.profiler, 25 calls after 3 warm-up calls) and,
   for the kernel, the call's time by CUDA events (``call_ms``, median of
   25), which adds the device's idle time while the host prepares the
   launch.  groupRectangles must match exactly, on
   clustered boxes and on the hard cases: a chain of 256 boxes each similar
   only to its neighbours in a random index order, one component holding
   every box, no valid candidate, N = 300, 784 and 1024; LRN within 1 bf16
   ulp in bf16 and rtol 1e-5 in float32, at the main path's shapes (which
   must take the kernels' vector instance), at odd shapes at B = 8, and
   with 3 channels and on a misaligned view (the scalar instance); the
   stem tail at (8, 112, 112, 64) and at shapes with stripe and ceil-mode
   edges, at least 99.9 % of the entries bit-equal, the rest within
   max(0.26, 2 bf16 ulps) in bf16 (0.26 is the JAX package's own
   stem-kernel tolerance) and within one e5m2 step in e5m2: the kernel and cuDNN sum in other orders, and a
   flipped rounding of an intermediate moves the conv sums downstream of it
   by a weight times its ulp.  Yardsticks, timed and used nowhere in the
   port: ``F.local_response_norm`` beside the LRN kernel, and the bf16
   path's own stem (LRN kernel, cuDNN convs, LRN + pool kernel) beside the
   stem-tail kernel;
4. parity: the float32 forward of 2 frames on the card and on the CPU with
   the same weights, heads within atol 1e-3; then decode + NMS of the
   card's heads on both devices, DetectionResult exactly equal;
5. main path: ``Detector("googlenet_detectnet", max_candidates=256)`` in
   bf16 on 8 seeded 448x448 frames.  Every kernel of the path must have
   launched in that run; the detections must equal decode + NMS of the same
   heads on the CPU.  Prints detections, frames/s and latency per batch,
   then checks and times the groupRectangles kernel again on that run's own
   candidates, whose numbers go into the JSON line (one predicate pass
   over the candidate pairs, whatever the clusters' shape).  Then 8 frames
   of 640x480, counted again: the card's resize within 1e-3 of the CPU's,
   detections equal to decode + NMS of the same heads on the CPU, every
   box centre inside the frame;
6. serving path: ``Detector("googlenet_detectnet_serving",
   max_candidates=256)``, e5m2 storage with bf16 compute, on 8 seeded
   448x448 frames.  The stem-tail and groupRectangles kernels must have
   launched in that run, the LRN kernels not; the detections must equal
   decode + NMS of the same heads on the CPU.  Prints detections, frames/s
   and latency per batch;
7. families: the VGG, FCN and ResNet-FPN families.  First, once per
   family, the float32 forward on the card against the CPU (1 frame of
   vgg_pyramid_detectnet at 448x448, 2 of the others), every head within
   1e-4 of its largest magnitude.  Then each detection configuration in
   bf16 on 8 seeded frames of its net's size with K = 256
   (vgg_pyramid_detectnet and its e5m2 preset at 448x448, fcn8s_bbox and
   its preset at 288x288, vgg_detectnet_train at 224x224, resnet_fpn_
   detectnet bf16 and with e5m2 block storage at 448x448), and fcn8s_bbox
   again at its default capacity, all 36 x 36 = 1296 cells per class: each
   run must launch the groupRectangles kernel and equal decode + NMS of
   the same heads on the CPU; prints detections, frames/s, host-clock
   latency and device-busy time per batch.  The kernel is then checked
   and timed on that default-capacity run's candidates (80 instances of
   N = 1296; its numbers join the JSON line as ``n1296_*``) and checked on
   N = 4096 (a random-order chain, one component).  Last the segment
   surface (demean -> forward -> argmax) of fcn32s_seg and its preset on 8
   frames of 224x224: on 2 frames, at least 98 % of the labels equal to
   the CPU's, and every other pixel a near-tie on the CPU (top two logits
   within 5 % of the logits' scale in bf16, 30 % in the e5m2 preset, whose
   flipped roundings spread);
8. train: the input gradients through the lrn and lrn_maxpool custom ops
   against autograd through their plain versions on the card, at the main
   path's shapes and with 67 channels, float32 within rtol 1e-6 and bf16
   within 1 ulp; the TF32 trap: with TF32 allowed by the caller, one
   ``parity()`` step of googlenet_detectnet at 448x448, B = 2, dropout 0,
   on the card and on the CPU from the same weights and batch, the losses
   within rtol 1e-5, the gradients (against the card's with TF32 off
   globally, and against the CPU's) and the updated parameters as stated
   at PARITY_LOSS_RTOL, with a control step whose backward runs in TF32
   failing the gradient limits, the caller's flags back after it, and the
   card's loss equal to the same forward's with TF32 off globally and
   unequal to it with TF32 on and no policy scope; the bf16
   Trainer of googlenet_detectnet at B = 8 for 3 warm-up and 20 timed
   steps on one fixed batch (finite losses, the smoothed loss below the
   first step's, a non-zero gradient on every parameter of conv1,
   conv2_reduce and conv2, each LRN kernel launched once a step), with
   steps/s, images/s, device busy per step, the LRN kernels' forward and
   plain backward time and peak memory; a snapshot of it holding the
   trained parameters, none at its step-0 value, whose
   ``Detector.from_checkpoint`` gives the in-memory parameters' detections
   (at least one), and which the e5m2 preset loads and serves; then
   vgg_detectnet_train under the
   bounding_box recipe (B = 32, 224x224), printed the same way;
9. data: training from scenes composed on the card
   (``torchfcn.data.device_compositor``) from a synthetic crop library (4
   classes, 32 crops with box and ellipse masks, drawn with numpy) on noise
   backgrounds.  One set of draws made on the cpu composes on the cpu and
   on the card with the caller's TF32 on: rects, labels and valid equal,
   seg equal but at pixels whose rendered mask lies within DATA_MASK_TOL
   of 0.5 (counted), the float image within DATA_IMAGE_ATOL away from
   them, and a control composed with the compositor's exact-float32 scopes
   made no-ops beyond DATA_IMAGE_ATOL; batches of the
   card's generator keep their invariants (rects in the frame, seg in its
   rects, pastes' scaled IoU at most 0.05, the same seed the same batch);
   a batch composes with no host synchronisation (sync debug mode
   "error"); the compositor's device busy, launches and batches/s at
   googlenet_detectnet 448x448 B = 16 and vgg_detectnet_train 224x224
   B = 32; googlenet_detectnet B = 16 trained from the pipeline and from a
   DeviceBatchCache of 30 batches (steps/s, images/s, device busy with the
   compositor's share, each LRN kernel once a step), both LRN kernels held
   against their plain versions on the B = 16 inputs of a composed step;
   and vgg_detectnet_train 224x224 with 4 classes trained from a cache, its
   detection_validator's held-out mAP on 64 scenes composed under another
   seed above VAL_MAP_LIMIT after training and below it at step 0, and the
   groupRectangles kernel held against its plain version on the trained
   validator's candidates of one chunk.

Then one JSON line of the families' numbers, one of the training runs'
numbers, one of the data phase's, one JSON line of per-kernel numbers
(with each kernel's launches per training step, per step fed by the
compositor and per validation), each kernel's time beside its
bound (``bound_ms``: the larger of the bytes it must move over 3.35 TB/s
and its operations over the peak rate of their type, 989 TFLOP/s on the
bf16 tensor cores, 67 TFLOP/s in float32, or 4.18e12/s on the special-
function unit, counted from this run's shapes and data) and, where one
PyTorch call computes the same function, that call's time
(``library_ms``), and last the result line
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.  Weights are the seeded Caffe "xavier" init; the coverage and bbox
head biases are set so that cells fire with boxes tall enough to survive
the NMS height filter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH, NET = 8, 448
K = 256
REPS, WARMUP = 25, 3
# the stem tail's bf16 tolerance: the JAX package's own for its stem kernel
# (tests/test_pallas_kernels.py:61), or 2 ulps where that is larger
STEM_ATOL = 0.26
# the H100 SXM's published peaks (bytes/s, operations/s); the special-
# function unit issues 16 operations per SM per clock, at the 1.98 GHz that
# the float32 peak assumes, on 132 SMs
HBM_BYTES_S = 3.35e12
TENSOR_BF16_OPS_S = 989e12
F32_OPS_S = 67e12
SFU_OPS_S = 132 * 16 * 1.98e9
# float32 operations counted per value: an LRN output (5 squares and
# their roundings, 4 adds, scale, offset, rsqrt, sqrt, rsqrt, 2 multiplies)
# and one SimilarRects pair test (2 min, add, multiply, 4 differences, 4
# compares)
LRN_OPS, PAIR_OPS = 17, 12
# special-function operations per LRN value: rsqrt, the rsqrt of the IEEE
# sqrt, rsqrt (csrc/common.cuh::lrn_factor)
LRN_SFU_OPS = 3


def bound(nbytes: float, tensor_ops: float = 0.0, f32_ops: float = 0.0,
          sfu_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and each kind of operation over its peak.  The special-
    function unit is one of those kinds: it issues a sixteenth of the
    float32 rate, and the first LRN + pool kernel, which evaluated each LRN
    value 2.25 times, needed twice its byte bound on that unit alone."""
    times = {"bytes": nbytes / HBM_BYTES_S,
             "operations": max(tensor_ops / TENSOR_BF16_OPS_S,
                               f32_ops / F32_OPS_S, sfu_ops / SFU_OPS_S)}
    by = max(times, key=times.get)
    return dict(bound_ms=times[by] * 1e3, bound_by=by)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn) -> float:
    """Median device time of ``fn`` over REPS runs, by CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def busy_ms(fn) -> float:
    """Device time of one call of ``fn``: the device self time of every
    kernel and copy it launches, summed over REPS calls under torch.profiler
    after WARMUP calls, per call.  Unlike CUDA events around the call, it
    leaves out the device's idle time while the host prepares a launch."""
    from torch.profiler import ProfilerActivity, profile

    from torchfcn.serve.profile import device_rows
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for _, us, _ in device_rows(prof))
    if total_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total_us / 1e3 / REPS


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each value of ``t``."""
    _, exp = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exp - 8)


def check_lrn_outputs(got, want, dtype, what) -> float:
    """bf16 within 1 ulp, float32 within rtol 1e-5; returns max |err|."""
    err = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        bad = int((err > bf16_ulp(want)).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} values beyond 1 bf16 ulp")
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0, msg=what)
    return float(err.max())


def nms_inputs(rng: np.random.Generator, device):
    """32 instances of the serving path's NMS input: clustered and random
    corner boxes over a 28x28 grid, coverage quantised to eighths so that
    ties straddle the top-K boundary, through select_candidates."""
    from torchfcn.serve.detector import select_candidates
    m, g = BATCH * 4, 28 * 28
    boxes = rng.uniform(-50, 500, (m, g, 4)).astype(np.float32)
    for i in range(m):
        at = 0
        for _ in range(int(rng.integers(1, 12))):
            x1, y1 = rng.uniform(0, 400, 2)
            x2, y2 = x1 + rng.uniform(20, 200), y1 + rng.uniform(20, 200)
            size = int(rng.integers(2, 40))
            boxes[i, at:at + size] = np.array([x1, y1, x2, y2]) + \
                rng.normal(0, 3, (size, 4))
            at += size
        boxes[i] = boxes[i, rng.permutation(g)]
    cvg = rng.integers(0, 8, (m, g)).astype(np.float32) / 8
    cand, valid = select_candidates(
        torch.from_numpy(cvg), torch.from_numpy(boxes),
        torch.from_numpy(cvg >= 0.5), K)
    return cand.contiguous().to(device), valid.contiguous().to(device)


def check_group_rects(rects, valid, what: str, timed: bool = True,
                      **nms) -> dict:
    """groupRectangles kernel against its plain version on the card: exact
    in every field; returns its numbers, both times and its bound.  ``nms``:
    group_threshold and eps, where not the defaults."""
    from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
    from torchfcn.ops.group_rects import group_rectangles
    got = group_rectangles_cuda(rects, valid, **nms)
    want = group_rectangles(rects, valid, **nms)
    torch.cuda.synchronize()
    for field in ("rects", "weights", "valid"):
        a, b = getattr(got, field), getattr(want, field)
        if not torch.equal(a, b):
            raise AssertionError(
                f"group_rects on {what}: {field} differs in "
                f"{int((a != b).sum())} entries")
    row = dict(max_abs_err=float((got.rects - want.rects).abs().max()))
    msg = f"group_rects {tuple(rects.shape)} on {what}: exact " \
        f"({int(got.valid.sum())} clusters kept)"
    if timed:
        # each input byte read once, each output written once; one
        # predicate test per pair of valid candidates
        m, n = valid.shape
        v = valid.sum(-1).double()
        row.update(ms=busy_ms(lambda: group_rectangles_cuda(rects, valid)),
                   call_ms=median_ms(
                       lambda: group_rectangles_cuda(rects, valid)),
                   plain_ms=busy_ms(lambda: group_rectangles(rects, valid)),
                   **bound(m * n * (17 + 21),
                           f32_ops=PAIR_OPS * float((v * (v - 1) / 2).sum())))
        msg += f", kernel {row['ms']:.4f} ms (call {row['call_ms']:.4f}), " \
            f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} " \
            f"ms ({row['bound_by']})"
    log("kernels", msg)
    return row


def chain_rects(rng, n: int):
    """n boxes of 100x100 at x = 15 k in a random index order: with eps 0.2
    (delta 20) each is similar only to its neighbours along the chain, one
    component of diameter n - 1."""
    k = rng.permutation(n).astype(np.float32)
    rects = np.stack([15 * k, np.zeros(n), np.full(n, 100.),
                      np.full(n, 100.)], -1).astype(np.float32)
    return torch.from_numpy(rects[None]), torch.ones(1, n, dtype=torch.bool)


def hard_group_rects(rng, dev) -> float:
    """groupRectangles on the hard cases, exact; returns the kernel's time
    on the 256-long chain."""
    rects, valid = chain_rects(rng, K)
    chain = check_group_rects(rects.to(dev), valid.to(dev),
                              f"a chain of {K} boxes in random order")
    if chain["ms"] > 0.1:
        log("kernels", f"group_rects: the chain takes {chain['ms']:.4f} ms, "
            f"above its 0.1 ms target")
    one = np.array([50., 60., 120., 130.], np.float32) + \
        rng.integers(-2, 3, (4, K, 4)).astype(np.float32)
    check_group_rects(torch.from_numpy(one).to(dev),
                      torch.ones(4, K, dtype=torch.bool, device=dev),
                      "one component of every box", timed=False)
    rects, _ = nms_inputs(rng, dev)
    check_group_rects(rects, torch.zeros(rects.shape[:2], dtype=torch.bool,
                                         device=dev),
                      "no valid candidate", timed=False)
    for m, n in ((3, 300), (5, 784), (2, 1024)):
        rects = torch.from_numpy(rng.uniform(-100, 500, (m, n, 4))
                                 .astype(np.float32))
        rects[:, : n // 2] = rects[:, :1] + torch.from_numpy(
            rng.normal(0, 3, (m, n // 2, 4)).astype(np.float32))
        check_group_rects(rects.to(dev),
                          torch.from_numpy(rng.random((m, n)) < 0.8).to(dev),
                          f"N = {n}, half one cluster", timed=False)
    rects, valid = chain_rects(rng, 1023)
    check_group_rects(rects.to(dev), valid.to(dev),
                      "a chain of 1023 boxes in random order", timed=False)
    return chain["ms"]


def phase_kernels(rng) -> dict:
    """Every kernel against its plain version on synthetic inputs; returns
    the LRN and stem-tail kernels' numbers for the JSON line, and the
    groupRectangles kernel's time on the 256-long chain."""
    import torch.nn.functional as F
    from torchfcn.ops.caffe_layers import lrn_across_channels, max_pool_caffe
    from torchfcn.ops.cuda.lrn import lrn_cuda, vector_instance
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda

    dev = torch.device("cuda")
    check_group_rects(*nms_inputs(rng, dev), "clustered + random boxes")
    rows = {"group_rects": dict(long_chain_ms=hard_group_rects(rng, dev))}

    cases = (
        ("lrn", (BATCH, 112, 112, 64), lrn_cuda, lrn_across_channels),
        ("lrn_maxpool", (BATCH, 112, 112, 192), lrn_maxpool_cuda,
         lambda x: max_pool_caffe(lrn_across_channels(x), 3, 2)),
    )
    for name, shape, kernel, plain in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 * 60).to(dev, dtype)
            if not vector_instance(dtype, shape[-1], x.data_ptr()):
                raise AssertionError(f"{name} {shape} {dtype}: the main "
                                     f"path's shape takes the scalar "
                                     f"instance")
            got, want = kernel(x), plain(x)
            torch.cuda.synchronize()
            err = check_lrn_outputs(got, want, dtype, f"{name} {dtype}")
            ms, call_ms = busy_ms(lambda: kernel(x)), median_ms(
                lambda: kernel(x))
            plain_ms = busy_ms(lambda: plain(x))
            log("kernels", f"{name} {shape} {dtype}: max|err| {err:.3g}, "
                f"kernel {ms:.4f} ms (call {call_ms:.4f}), plain "
                f"{plain_ms:.4f} ms")
        # the serving path runs bf16: its numbers go into the JSON line
        nbytes = (x.numel() + got.numel()) * x.element_size()
        rows[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                          plain_ms=plain_ms, library_ms=None,
                          **bound(nbytes, f32_ops=LRN_OPS * x.numel(),
                                  sfu_ops=LRN_SFU_OPS * x.numel()))
        if name == "lrn":
            # the one PyTorch call for the same function, on the same input
            rows[name]["library_ms"] = busy_ms(
                lambda: F.local_response_norm(x.permute(0, 3, 1, 2), 5,
                                              1e-4, 0.75, 1.0))
            log("kernels", f"lrn bf16: F.local_response_norm "
                f"{rows[name]['library_ms']:.4f} ms")
        log("kernels", f"{name} bf16: bound {rows[name]['bound_ms']:.4f} ms "
            f"({rows[name]['bound_by']})")
    check_lrn_edges(rng, dev, {name: (kernel, plain)
                               for name, _, kernel, plain in cases})
    rows["stem_tail"] = check_stem_tail(rng, dev)
    return rows


# the LRN kernels off the main path's shapes, in both instances: odd H and
# W at B = 8 (lrn_maxpool at (8, 47, 45): a last stripe of 2 pool rows
# after stripes of 3, a last tile of 4 pool columns after tiles of 6), 3
# channels (scalar instance), and a view one element past an aligned
# allocation (scalar instance)
LRN_EDGE_SHAPES = {
    "lrn": ((BATCH, 57, 45, 192), (2, 15, 13, 3)),
    "lrn_maxpool": ((BATCH, 57, 45, 192), (BATCH, 70, 33, 64),
                    (BATCH, 47, 45, 192), (2, 15, 13, 3)),
}
MISALIGNED_SHAPE = (2, 15, 13, 64)


def check_lrn_edges(rng, dev, kernels) -> None:
    """Each LRN kernel against its plain version at LRN_EDGE_SHAPES and on
    a misaligned view, in float32 and bf16, within the main shapes'
    bounds; the instance each takes is checked and printed."""
    from torchfcn.ops.cuda.lrn import vector_instance
    for name, (kernel, plain) in kernels.items():
        for shape in LRN_EDGE_SHAPES[name] + (None,):
            for dtype in (torch.float32, torch.bfloat16):
                misaligned = shape is None
                shp = MISALIGNED_SHAPE if misaligned else shape
                data = (torch.from_numpy(rng.standard_normal(shp, np.float32))
                        * 60).to(dev, dtype)
                if misaligned:
                    x = torch.empty(data.numel() + 1, dtype=dtype,
                                    device=dev)[1:].view(shp)
                    x.copy_(data)
                else:
                    x = data
                vector = vector_instance(dtype, shp[-1], x.data_ptr())
                if vector != (not misaligned and shp[-1] != 3):
                    raise AssertionError(f"{name} {shp} {dtype}: took the "
                                         f"{'vector' if vector else 'scalar'}"
                                         f" instance")
                got, want = kernel(x), plain(x)
                torch.cuda.synchronize()
                what = f"{name} {shp}{' misaligned' if misaligned else ''} " \
                    f"{dtype}"
                err = check_lrn_outputs(got, want, dtype, what)
                log("kernels", f"{what}, {'vector' if vector else 'scalar'} "
                    f"instance: max|err| {err:.3g}")


def e5m2_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many e5m2 values apart two e5m2 tensors are, entrywise."""
    def ordinal(t):
        code = t.view(torch.uint8).int()
        return torch.where(code >= 128, -(code & 127), code & 127)
    return (ordinal(a) - ordinal(b)).abs()


# the serving path's shape first (timed); then edges at B <= 2, one pool
# row per stripe: a ceil-mode pool edge, the smallest input, the widest;
# then at B = 8 stripes of several pool rows, with an odd H (14 stripes of
# 2) and a short last stripe (Ho = 35 in stripes of 3).  The one-image
# shapes have few outputs, so one flipped intermediate rounding can move
# their bit-equal share by about 0.1 %, the bound's whole margin: whether
# they pass depends on their seeded inputs, which are drawn in this order
STEM_SHAPES = ((BATCH, 112, 112, 64), (1, 30, 30, 64), (2, 57, 45, 64),
               (1, 3, 3, 64), (1, 9, 128, 64), (BATCH, 57, 45, 64),
               (BATCH, 70, 33, 64))


def check_stem_tail(rng, dev) -> dict:
    """The stem-tail kernel against its plain version (float32 convs of
    the bf16 values, TF32 off) in bf16 and in e5m2, with the seeded model's
    conv2 weights and random biases, at the serving path's shape (timed)
    and at shapes with stripe, ceil-mode and width edges; returns the e5m2
    instance's numbers at the serving path's shape, with the bf16 path's
    own stem chain on the same input beside it (``chain_ms``)."""
    import torch.nn.functional as F
    from torchfcn.models import build as build_model
    from torchfcn.models.layers import LRN, LRNMaxPool, nchw
    from torchfcn.ops.cuda.stem import stem_tail_cuda
    from torchfcn.ops.stem import stem_tail
    model = build_model("googlenet_detectnet_serving")
    model.init_weights(torch.Generator().manual_seed(SEED))
    weights = [p.detach().to(dev, torch.bfloat16) for p in (
        model.conv2_reduce.weight, model.conv2_reduce.bias,
        model.conv2.weight, model.conv2.bias)]
    for i in (1, 3):
        weights[i] = (torch.from_numpy(rng.normal(
            0, 0.1, weights[i].shape[0]).astype(np.float32))
            .to(dev, torch.bfloat16))
    for shape in STEM_SHAPES:
        x = torch.from_numpy(np.abs(rng.standard_normal(shape, np.float32))
                             * 40).to(dev)
        for store in (torch.bfloat16, torch.float8_e5m2):
            xs = x.to(store)
            arg = None if store == torch.bfloat16 else store
            got = stem_tail_cuda(xs, *weights, arg)
            want = stem_tail(xs, *weights, arg)
            torch.cuda.synchronize()
            g, w = got.float(), want.float()
            err = (g - w).abs()
            equal = float((g == w).float().mean())
            if arg is None:
                bad = err > torch.clamp(2 * bf16_ulp(w), min=STEM_ATOL)
            else:
                bad = e5m2_steps(got, want) > 1
            if bool(bad.any()) or equal < 0.999:
                raise AssertionError(
                    f"stem_tail {shape} {store}: {int(bad.sum())} entries "
                    f"beyond tolerance, {equal:.6f} bit-equal; got "
                    f"{g[bad][:5].tolist()} want {w[bad][:5].tolist()}")
            msg = f"stem_tail {shape} {store}: max|err| " \
                f"{float(err.max()):.3g}, {equal * 100:.4f} % bit-equal"
            if shape == STEM_SHAPES[0]:
                ms = busy_ms(lambda: stem_tail_cuda(xs, *weights, arg))
                call_ms = median_ms(lambda: stem_tail_cuda(xs, *weights, arg))
                plain_ms = busy_ms(lambda: stem_tail(xs, *weights, arg))
                msg += f", kernel {ms:.4f} ms (call {call_ms:.4f}), plain " \
                    f"{plain_ms:.4f} ms"
                if arg is not None:   # the serving path's: into the JSON
                    row = dict(max_abs_err=float(err.max()), ms=ms,
                               call_ms=call_ms, plain_ms=plain_ms,
                               library_ms=None)
                    serving_x = xs
            log("kernels", msg)
    # the bf16 path's own stem on the same (bf16) values: the lrn kernel,
    # cuDNN's 1x1 and 3x3 convs with bias and ReLU, the lrn_maxpool kernel
    norm1, norm2 = LRN(), LRNMaxPool()
    xs = serving_x
    xb = nchw(xs.to(torch.bfloat16))

    def chain():
        y = norm1(xb)
        y = F.relu(F.conv2d(y, weights[0], weights[1]))
        y = F.relu(F.conv2d(y, weights[2], weights[3], padding=1))
        return norm2(y)

    row["chain_ms"] = busy_ms(chain)
    # bytes: e5m2 input and output, bf16 weights, float32 biases; operations:
    # the two convs' multiply-adds on the tensor cores, the LRNs in float32
    # and on the special-function unit
    b, h, w, _ = xs.shape
    macs = b * h * w * (64 * 64 + 192 * 64 * 9)
    lrn_values = b * h * w * (64 + 192)
    row.update(bound(xs.numel() + b * (h // 2) * (w // 2) * 192
                     + (64 * 64 + 192 * 576) * 2
                     + (64 + 192) * 4, tensor_ops=2 * macs,
                     f32_ops=LRN_OPS * lrn_values,
                     sfu_ops=LRN_SFU_OPS * lrn_values))
    log("kernels", f"stem_tail {tuple(xs.shape)} e5m2: kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bf16 path's "
        f"stem chain {row['chain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
        f"ms ({row['bound_by']})")
    if row["ms"] > 0.5 or row["ms"] >= row["chain_ms"]:
        log("kernels", "stem_tail: above its 0.5 ms target or not below the "
            "bf16 path's stem chain")
    return row


def assert_same_result(a, b, what: str) -> None:
    for field in ("boxes", "confidence", "valid"):
        x, y = getattr(a, field).cpu(), getattr(b, field).cpu()
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: DetectionResult.{field} differs "
                                 f"in {int((x != y).sum())} entries")


def phase_parity(rng) -> None:
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.profile import bias_heads
    frames = rng.integers(0, 256, (2, NET, NET, 3), dtype=np.uint8)
    dets = [Detector("googlenet_detectnet", max_candidates=K,
                     dtype=torch.float32, rng_seed=SEED, device=d)
            for d in ("cuda", "cpu")]
    for det in dets:
        bias_heads(det)
    with torch.inference_mode():
        heads = [det._forward(torch.as_tensor(frames, device=det.device))
                 for det in dets]
        diff = max(float((g.cpu() - c).abs().max())
                   for g, c in zip(heads[0], heads[1]))
        if not diff <= 1e-3:
            raise AssertionError(f"parity: heads differ by {diff} > 1e-3")
        res = [det._decode_nms(*(h.to(det.device) for h in heads[0]),
                               (NET, NET)) for det in dets]
    torch.cuda.synchronize()
    assert_same_result(res[0], res[1], "parity")
    n_det = int(res[0].valid.sum())
    if n_det == 0:
        raise AssertionError("parity: no detections, nothing was compared")
    log("parity", f"f32 heads max|gpu-cpu| {diff:.3g} (atol 1e-3); "
        f"decode+NMS on the card's heads: DetectionResult equal on cuda "
        f"and cpu ({n_det} detections)")


def run_counted(det, frames, counters, required, what: str):
    """One run of ``det`` on ``frames`` with every launch count set to 0
    just before it and read just after; raises if a kernel of ``required``
    did not launch.  Returns (result, launches)."""
    for fn in counters.values():
        fn.launches = 0
    res = det(frames)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    missing = [name for name in required if launches[name] == 0]
    if missing:
        raise AssertionError(f"{what} launched no {missing} kernel")
    k = min(det.config.candidate_capacity, det.grid.grid_h * det.grid.grid_w)
    classes = det.grid.num_classes - (det.spec.background_channel is not None)
    if res.boxes.shape != (len(frames), classes, k, 4) \
            or res.boxes.dtype != torch.int32:
        raise AssertionError(f"{what}: boxes {tuple(res.boxes.shape)} "
                             f"{res.boxes.dtype}")
    if not bool(torch.isfinite(res.confidence).all()):
        raise AssertionError(f"{what}: non-finite confidence")
    if int(res.valid.sum()) == 0:
        raise AssertionError(f"{what}: no detections, nothing was compared")
    return res, launches


def check_against_cpu(det, frames, res, what: str):
    """``res`` must equal decode + NMS on the CPU of the card's heads for
    the same frames; returns those heads."""
    from torchfcn.serve.detector import Detector
    with torch.inference_mode():
        heads = det._forward(torch.as_tensor(frames, device="cuda"))
        cpu = Detector(det.config.model, config=det.config,
                       dtype=torch.bfloat16, rng_seed=SEED, device="cpu")
        want = cpu._decode_nms(*(h.cpu() for h in heads), frames.shape[1:3])
    assert_same_result(res, want, f"{what} vs decode+NMS on the cpu")
    return heads


def batch_latency(det, frames) -> float:
    """Median host-clock seconds per batch, each ending in a synchronize."""
    times = []
    for _ in range(WARMUP + REPS):
        t0 = time.perf_counter()
        det(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[WARMUP:])


def phase_main_path(rng, counters, card: str):
    """Returns the launch counts of one main-path run and the
    groupRectangles kernel's numbers on that run's candidates.  ``card`` is
    nvidia-smi's name and power limit, printed beside the rate."""
    from torchfcn.ops.grid_codec import decode_gridboxes
    from torchfcn.ops.image import resize_bilinear
    from torchfcn.serve.detector import Detector, select_candidates
    from torchfcn.serve.profile import bias_heads
    det = Detector("googlenet_detectnet", max_candidates=K,
                   dtype=torch.bfloat16, rng_seed=SEED, device="cuda")
    bias_heads(det)
    frames = rng.integers(0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)
    res, launches = run_counted(det, frames, counters, counters, "main path")
    heads = check_against_cpu(det, frames, res, "main path")
    # the kernel on the main path's own candidates: its JSON numbers
    with torch.inference_mode():
        boxes, cvg, valid = decode_gridboxes(
            *heads, det.grid, det.config.detection_threshold)
        cand, cand_valid = select_candidates(cvg, boxes, valid, K)
    row = check_group_rects(cand.reshape(-1, K, 4).contiguous(),
                            cand_valid.reshape(-1, K).contiguous(),
                            "the main path's candidates")
    latency = batch_latency(det, frames)
    log("main", f"Detector googlenet_detectnet bf16 B={BATCH} {NET}x{NET} "
        f"K={K}: {int(res.valid.sum())} detections; launches {launches}; "
        f"{BATCH / latency:.1f} frames/s, {latency * 1e3:.3f} ms per batch "
        f"(median of {REPS}, host clock, uint8 frames from host memory) "
        f"on {card}")

    # camera frames of another size: resized on the card
    cam = rng.integers(0, 256, (BATCH, 480, 640, 3), dtype=np.uint8)
    res, cam_launches = run_counted(det, cam, counters, counters,
                                    "main path on 640x480 frames")
    resized = resize_bilinear(torch.as_tensor(cam, device="cuda"),
                              (NET, NET))
    diff = float((resized.cpu()
                  - resize_bilinear(torch.from_numpy(cam), (NET, NET)))
                 .abs().max())
    if not diff <= 1e-3:
        raise AssertionError(f"resize: card and cpu differ by {diff} > 1e-3")
    check_against_cpu(det, cam, res, "main path on 640x480 frames")
    boxes = res.boxes[res.valid].float()
    cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
    if not bool(((cx >= 0) & (cx < 640) & (cy >= 0) & (cy < 480)).all()):
        raise AssertionError("640x480 frames: a box centre lies outside")
    log("main", f"640x480 frames resized to {NET}x{NET} on the card: "
        f"max|card-cpu| {diff:.3g} (atol 1e-3); {int(res.valid.sum())} "
        f"detections in frame coordinates, equal to decode+NMS on the cpu; "
        f"launches {cam_launches}")
    return launches, row


def phase_serving(rng, counters, card: str) -> dict:
    """The fp8 serving preset; returns its launch counts."""
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.profile import bias_heads
    det = Detector("googlenet_detectnet_serving", max_candidates=K,
                   dtype=torch.bfloat16, rng_seed=SEED, device="cuda")
    bias_heads(det)
    frames = rng.integers(0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)
    res, launches = run_counted(det, frames, counters,
                                ("stem_tail", "group_rects"), "serving path")
    if launches["lrn"] or launches["lrn_maxpool"]:
        raise AssertionError(f"serving path launched LRN kernels: "
                             f"{launches}")
    check_against_cpu(det, frames, res, "serving path")
    latency = batch_latency(det, frames)
    log("serving", f"Detector googlenet_detectnet_serving e5m2 storage, "
        f"bf16 compute, B={BATCH} {NET}x{NET} K={K}: "
        f"{int(res.valid.sum())} detections; launches {launches}; "
        f"{BATCH / latency:.1f} frames/s, {latency * 1e3:.3f} ms per batch "
        f"(median of {REPS}, host clock, uint8 frames from host memory) "
        f"on {card}")
    return launches


# the families phase: (model, model_kwargs) at B = 8 on frames of the
# model's net size, K = 256; fcn8s_bbox again at its default capacity, all
# 36 x 36 = 1296 cells per class
FAMILY_CONFIGS = (
    ("vgg_pyramid_detectnet", None), ("vgg_pyramid_detectnet_serving", None),
    ("fcn8s_bbox", None), ("fcn8s_bbox_serving", None),
    ("vgg_detectnet_train", None),
    ("resnet_fpn_detectnet", None),
    ("resnet_fpn_detectnet", {"store_dtype": torch.float8_e5m2}),
)
SEG_CONFIGS = ("fcn32s_seg", "fcn32s_seg_serving")
# float32 card against CPU, once per family, on 1-2 frames: each head
# within PARITY_RTOL of its largest magnitude (float32 convolutions in
# other orders and algorithms; the GoogLeNet parity phase measures 4e-6)
PARITY_FAMILIES = (("vgg_pyramid_detectnet", 1), ("vgg_detectnet_train", 2),
                   ("fcn8s_bbox", 2), ("resnet_fpn_detectnet", 2),
                   ("fcn32s_seg", 2))
PARITY_RTOL = 1e-4
# bf16 segment labels: at least SEG_AGREE of the pixels of 2 frames must
# get the CPU's label, and every pixel that does not must be a near-tie on
# the CPU: its top two logits closer than SEG_GAP of the logits' largest
# magnitude.  bf16 convolutions round in other places on the two devices,
# and in the e5m2 preset a flipped rounding moves a stored value by a
# quarter and spreads through the layers after it (as against tpufcn,
# tests/test_torch_family_serving.py)
SEG_AGREE = 0.98
SEG_GAP = {"fcn32s_seg": 0.05, "fcn32s_seg_serving": 0.3}

def family_parity(name: str, n: int, rng) -> str:
    """The float32 forward of ``name`` on ``n`` frames, card against CPU,
    same seeded weights, TF32 off; raises beyond PARITY_RTOL."""
    from torchfcn.models import get_spec
    from torchfcn.serve.detector import serving_model
    from torchfcn.ops.image import demean_bgr
    spec = get_spec(name)
    net = spec.grid.im_height
    frames = torch.from_numpy(rng.integers(0, 256, (n, net, net, 3),
                                           dtype=np.uint8))
    x = frames if spec.preprocessing == "shift127" else demean_bgr(frames)
    outs = []
    for dev in ("cuda", "cpu"):
        model = serving_model(name, torch.float32, SEED, None, dev)
        with torch.inference_mode():
            outs.append({k: v.cpu() for k, v in model(x.to(dev)).items()})
    msg = []
    for key, want in outs[1].items():
        diff = float((outs[0][key] - want).abs().max())
        scale = float(want.abs().max())
        if not diff <= PARITY_RTOL * scale:
            raise AssertionError(f"{name} f32 {key}: card and cpu differ by "
                                 f"{diff} > {PARITY_RTOL} x {scale}")
        msg.append(f"{key} {diff:.3g} of {scale:.3g}")
    return f"{name} f32 card vs cpu on {n} frame(s), max|diff|: " + \
        ", ".join(msg)


def run_family(det, frames, counters, card: str, what: str) -> dict:
    """One counted run of a detection configuration that must launch the
    groupRectangles kernel, its detections against decode + NMS on the CPU,
    its rate and device time; returns its numbers and the run's heads."""
    res, launches = run_counted(det, frames, counters, ("group_rects",),
                                what)
    heads = check_against_cpu(det, frames, res, what)
    latency = batch_latency(det, frames)
    busy = busy_ms(lambda: det(frames))
    k = res.boxes.shape[2]
    row = dict(config=what, batch=len(frames), size=frames.shape[1], k=k,
               detections=int(res.valid.sum()), frames_s=len(frames) / latency,
               ms_batch=latency * 1e3, busy_ms=busy, launches=launches)
    log("families", f"{what} B={len(frames)} {frames.shape[1]}x"
        f"{frames.shape[2]} K={k}: {row['detections']} detections, equal "
        f"to decode+NMS on the cpu; launches {launches}; "
        f"{row['frames_s']:.1f} frames/s, {row['ms_batch']:.3f} ms per "
        f"batch (median of {REPS}, host clock), device busy {busy:.3f} ms "
        f"per batch, on {card}")
    return row, heads


def run_segment(name: str, counters, card: str, rng) -> dict:
    """The segment surface of ``name`` on 8 frames of its size: labels
    against the CPU's on 2 frames away from near-ties; rate and device
    time."""
    from torchfcn.models import get_spec
    from torchfcn.serve.segment import Segmenter
    net = get_spec(name).grid.im_height
    frames = rng.integers(0, 256, (BATCH, net, net, 3), dtype=np.uint8)
    seg = Segmenter(name, dtype=torch.bfloat16, rng_seed=SEED, device="cuda")
    for fn in counters.values():
        fn.launches = 0
    labels = seg(frames)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    if labels.shape != (BATCH, net, net) or labels.dtype != torch.int64:
        raise AssertionError(f"{name}: labels {tuple(labels.shape)} "
                             f"{labels.dtype}")
    cpu = Segmenter(name, dtype=torch.bfloat16, rng_seed=SEED, device="cpu")
    with torch.inference_mode():
        logits = cpu.logits(torch.from_numpy(frames[:2]))
    top2 = logits.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / logits.abs().max()
    agree = labels[:2].cpu() == logits.argmax(-1)
    worst = float(gap[~agree].max()) if not bool(agree.all()) else 0.0
    share = float(agree.float().mean())
    if share < SEG_AGREE or worst >= SEG_GAP[name]:
        raise AssertionError(
            f"{name}: labels equal to the cpu's on {share:.4f} of the "
            f"pixels; a pixel that differs has a top-two gap of {worst:.3f} "
            f"of the logits' scale (limits {SEG_AGREE}, {SEG_GAP[name]})")
    latency = batch_latency(seg, frames)
    busy = busy_ms(lambda: seg(frames))
    row = dict(config=name, batch=BATCH, size=net, frames_s=BATCH / latency,
               ms_batch=latency * 1e3, busy_ms=busy, launches=launches)
    log("families", f"{name} segment surface B={BATCH} {net}x{net}: labels "
        f"equal to the cpu's on {share * 100:.2f} % of the pixels, the "
        f"others near-ties (top-two gap at most {worst:.3f} of the logits' "
        f"scale, limit {SEG_GAP[name]}); "
        f"{row['frames_s']:.1f} frames/s, {row['ms_batch']:.3f} ms per "
        f"batch (median of {REPS}, host clock), device busy {busy:.3f} ms "
        f"per batch, on {card}")
    return row


def phase_families(rng, counters, card: str):
    """The VGG, FCN and ResNet-FPN families; returns their rows and the
    groupRectangles kernel's numbers on fcn8s_bbox's default-capacity
    candidates (N = 1296) for the JSON line."""
    from torchfcn.models import get_spec
    from torchfcn.ops.grid_codec import decode_gridboxes
    from torchfcn.serve.detector import Detector, select_candidates
    from torchfcn.serve.profile import bias_heads
    for name, n in PARITY_FAMILIES:
        log("families", family_parity(name, n, rng))
    rows = []
    for name, kwargs in FAMILY_CONFIGS:
        net = get_spec(name).grid.im_height
        frames = rng.integers(0, 256, (BATCH, net, net, 3), dtype=np.uint8)
        capacities = (K, None) if name == "fcn8s_bbox" else (K,)
        for k in capacities:
            det = Detector(name, max_candidates=k, dtype=torch.bfloat16,
                           rng_seed=SEED, model_kwargs=kwargs, device="cuda")
            bias_heads(det)
            what = name + ("" if kwargs is None else
                           " store_dtype=e5m2") + \
                ("" if k else " default capacity")
            row, heads = run_family(det, frames, counters, card, what)
            rows.append(row)
            if k is None:
                cov, bboxes = heads
    # the kernel at N = 1296 on the candidates of fcn8s_bbox's default-
    # capacity run (its 10 foreground classes), then at N = 4096
    grid = dataclasses.replace(get_spec("fcn8s_bbox").grid, num_classes=10)
    n = grid.grid_h * grid.grid_w
    with torch.inference_mode():
        boxes, cvg, valid = decode_gridboxes(cov[..., 1:], bboxes[..., 4:],
                                             grid, 0.5)
        cand, cand_valid = select_candidates(cvg, boxes, valid, n)
    big = check_group_rects(cand.reshape(-1, n, 4).contiguous(),
                            cand_valid.reshape(-1, n).contiguous(),
                            "fcn8s_bbox's default-capacity candidates")
    rects, valid = chain_rects(rng, 4096)
    check_group_rects(rects.cuda(), valid.cuda(),
                      "a chain of 4096 boxes in random order")
    one = np.array([50., 60., 120., 130.], np.float32) + \
        rng.integers(-2, 3, (2, 4096, 4)).astype(np.float32)
    check_group_rects(torch.from_numpy(one).cuda(),
                      torch.ones(2, 4096, dtype=torch.bool, device="cuda"),
                      "N = 4096, one component", timed=False)
    rows += [run_segment(name, counters, card, rng) for name in SEG_CONFIGS]
    return rows, {f"n{n}_{key}": value for key, value in big.items()
                  if key != "max_abs_err"}


# the train phase: the LRN ops' gradients at the main path's shapes and at
# an odd channel count (the scalar instance); the parity step at B = 2; the
# bf16 Trainer of googlenet_detectnet at B = 8 (448x448) and of
# vgg_detectnet_train under the bounding_box recipe (B = 32, 224x224), each
# for TRAIN_WARMUP + TRAIN_STEPS steps on one fixed batch of M = 8 GT rects
# per image
GRAD_SHAPES = {"lrn": ((BATCH, 112, 112, 64), (BATCH, 57, 45, 67)),
               "lrn_maxpool": ((BATCH, 112, 112, 192), (BATCH, 57, 45, 67))}
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_M = 3, 20, 8
PROFILED_STEPS, TRAIN_TOP = 5, 10
# the parity step's limits, each set between the sound step's reading and
# a control step whose forward runs under the policy and whose backward and
# update run with the caller's TF32 on (NVIDIA H100 80GB HBM3, 700 W):
# - the losses, card vs CPU, within PARITY_LOSS_RTOL;
# - every gradient within PARITY_CARD_GRAD_RTOL of its tensor's scale of
#   the same step's on the card with TF32 off globally and no policy scope
#   (sound at most 6.6e-7, the weight gradients' summation order varying
#   from run to run; control 6.8e-4 in the median tensor);
# - card vs CPU, the median over weight tensors of the median entry's
#   |diff| over the tensor's scale at most PARITY_CPU_GRAD_MEDIAN (sound
#   7.9e-9, control 2.3e-7).  A median over entries: where the two devices
#   route a max pool's gradient to other positions of a near-tie (top two
#   values of a window within the devices' rounding difference), every
#   gradient below it differs at some entries by far more than rounding
#   (max|diff| up to 2.2e-3 of scale in the sound step);
# - the updated parameters, card vs CPU: at least PARITY_PARAM_SHARE of
#   each tensor's entries within PARITY_PARAM_LR_FRACTION * lr (sound
#   0.937 at least).  Adam's first update moves each entry by about
#   lr * sign(g), so this holds the update and its gradients' signs, not
#   the backward's precision (the control reads 0.956): the gradients
#   carry that test.
# The control must fail both gradient limits, or the trap cannot tell.
PARITY_LOSS_RTOL = 1e-5
PARITY_CARD_GRAD_RTOL = 1e-5
PARITY_CPU_GRAD_MEDIAN = 5e-8
PARITY_PARAM_LR_FRACTION, PARITY_PARAM_SHARE = 1e-2, 0.9
# the coverage bias for the snapshot round trip: after the train run the
# coverage head lies far below the 0.5 threshold on random frames, and
# bias_heads' 1.0 leaves no detection
SNAPSHOT_CVG_BIAS = 32.0


def train_batch(rng, b: int, net: int, classes: int) -> dict:
    """A seeded training batch: uint8 frames, TRAIN_M GT rects (x, y, w, h)
    per image with labels and valid flags (about 80 % valid)."""
    xy = rng.uniform(0, net * 0.7, (b, TRAIN_M, 2))
    wh = rng.uniform(net / 16, net / 3, (b, TRAIN_M, 2))
    return {"image": rng.integers(0, 256, (b, net, net, 3), dtype=np.uint8),
            "rects": np.concatenate([xy, wh], -1).astype(np.float32),
            "labels": rng.integers(0, classes, (b, TRAIN_M)).astype(np.int32),
            "valid": rng.random((b, TRAIN_M)) < 0.8}


def check_op_gradients(rng) -> None:
    """The input gradients through the lrn and lrn_maxpool custom ops on
    the card against autograd through their plain versions on the card,
    same input and output gradient: float32 within rtol 1e-6, bf16 within
    1 ulp."""
    from torchfcn.ops.caffe_layers import lrn_across_channels
    from torchfcn.ops.cuda.lrn import lrn_cuda
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool, lrn_maxpool_cuda
    ops = {"lrn": (lrn_cuda, lrn_across_channels),
           "lrn_maxpool": (lrn_maxpool_cuda, lrn_maxpool)}
    for name, (op, plain) in ops.items():
        for shape in GRAD_SHAPES[name]:
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                     * 60).to("cuda", dtype).requires_grad_(True)
                y = op(x)
                g = torch.from_numpy(rng.standard_normal(
                    tuple(y.shape), np.float32)).to("cuda", dtype)
                got, = torch.autograd.grad(y, x, g)
                want, = torch.autograd.grad(plain(x), x, g)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                if dtype == torch.bfloat16:
                    bad = int((err > bf16_ulp(want)).sum())
                    if bad:
                        raise AssertionError(
                            f"{name} {shape} bf16 gradient: {bad} values "
                            f"beyond 1 ulp of the plain version's")
                else:
                    torch.testing.assert_close(
                        got, want, rtol=1e-6, atol=0,
                        msg=f"{name} {shape} float32 gradient")
                log("train", f"{name} {shape} {dtype}: gradient through the "
                    f"custom op vs autograd through the plain version on the "
                    f"card, max|diff| {float(err.max()):.3g} "
                    f"({int((err == 0).float().mean() * 100)} % bit-equal)")


@contextlib.contextmanager
def recorded_max_pools(inputs: list):
    """Appends the input, arguments and keywords of every max pool that
    ``torchfcn.ops.caffe_layers.max_pool_caffe`` runs inside the scope to
    ``inputs``."""
    import torch.nn.functional as F

    from torchfcn.ops import caffe_layers

    class Recording:
        def __getattr__(self, name):
            return getattr(F, name)

        def max_pool2d(self, x, *args, **kw):
            inputs.append((x.detach(), args, kw))
            return F.max_pool2d(x, *args, **kw)

    caffe_layers.F = Recording()
    try:
        yield
    finally:
        caffe_layers.F = F


@contextlib.contextmanager
def recorded_calls(module, name: str, calls: list):
    """Appends the arguments, by name with the defaults filled in, of every
    call of ``module.<name>`` inside the scope to ``calls``; the function
    itself still runs (and counts its launches)."""
    import inspect
    fn = getattr(module, name)
    signature = inspect.signature(fn)

    def recording(*args, **kw):
        bound_args = signature.bind(*args, **kw)
        bound_args.apply_defaults()
        calls.append(dict(bound_args.arguments))
        return fn(*args, **kw)

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, fn)


def routed_apart(card: list, cpu: list) -> tuple:
    """(windows, windows routed to other positions, largest top-two gap of
    those over the input's scale, smallest max|diff| between the card's
    and the CPU's inputs over their scale among the pools with such
    windows) of the max pools of one forward recorded on the card and on
    the CPU.  The LRN + pool layer is left
    out: its forward runs the kernel on the card and the plain version on
    the CPU, so the two lists differ there."""
    import torch.nn.functional as F
    lrn_pool = (192, NET // 4, NET // 4)
    card, cpu = ([r for r in side if tuple(r[0].shape[1:]) != lrn_pool]
                 for side in (card, cpu))
    windows = apart = 0
    gap = 0.0
    diff = []
    for (xg, args, kw), (xc, _, _) in zip(card, cpu):
        ig = F.max_pool2d(xg, *args, return_indices=True, **kw)[1].cpu()
        yc, ic = F.max_pool2d(xc, *args, return_indices=True, **kw)
        scale = float(xc.abs().max())
        moved = (ig != ic) & (yc > 0)
        windows += yc.numel()
        apart += int(moved.sum())
        if bool(moved.any()):
            diff.append(float((xg.cpu() - xc).abs().max()) / scale)
            flat = xc.flatten(2)
            gaps = (flat.gather(2, ig.flatten(2))
                    - flat.gather(2, ic.flatten(2))).abs().flatten()
            gap = max(gap, float(gaps[moved.flatten()].max()) / scale)
    return windows, apart, gap, min(diff, default=0.0)


def parity_step(rng) -> None:
    """The TF32 trap: TF32 allowed by the caller for cuDNN and matmuls, one
    parity() step of googlenet_detectnet at 448x448, B = 2, dropout 0, on
    the card and on the CPU from the same seeded weights and batch, held
    to the limits stated above, and the caller's flags back afterwards.
    On the card the same step's loss also equals, bit for bit, that of the
    same float32 forward with TF32 off globally, and differs from it with
    TF32 on and no policy scope: the scope, and not a default, turned TF32
    off.  Prints how many max-pool windows the two devices routed apart."""
    from torchfcn.core.config import GridConfig, TrainConfig
    from torchfcn.core.dtypes import DTypePolicy
    from torchfcn.models import build as build_model
    from torchfcn.train.step import (
        apply_update, init_state, make_grads_fn, make_loss_fn,
        make_schedule, make_train_step)
    cfg = TrainConfig(grid=GridConfig(NET, NET, 16, 4),
                      model="googlenet_detectnet")
    batch = train_batch(rng, 2, NET, 4)
    loss_fn = make_loss_fn(cfg, preprocessing="shift127")

    def fresh(dev):
        state = init_state(build_model(cfg.model, dropout_rate=0.0), cfg,
                           rng_seed=SEED, device=dev,
                           policy=DTypePolicy.parity())
        return state, {k: torch.as_tensor(v).to(dev)
                       for k, v in batch.items()}

    def grads(state) -> dict:
        return {k: p.grad.cpu() for k, p in state.model.named_parameters()}

    def unscoped() -> tuple:
        """The parity model's loss and gradients on the card outside any
        policy scope."""
        state, b = fresh("cuda")
        _, metrics = make_grads_fn(loss_fn)(state.model.train(), b,
                                            state.generator)
        return float(metrics["loss_total"]), grads(state)

    def tf32_backward() -> tuple:
        """The control: the forward under the policy's scope, the backward
        and the update with the caller's flags (TF32 on)."""
        state, b = fresh("cuda")
        state.model.train()
        with state.policy.precision():
            loss, _ = loss_fn(state.model, b, state.generator)
        loss.backward()
        apply_update(state.optimizer, make_schedule(cfg), state.step)
        return grads(state), {k: p.detach().cpu()
                              for k, p in state.model.named_parameters()}

    def worst(got: dict, want: dict) -> float:
        """The largest max|diff| over a tensor's scale."""
        return max(float((got[n] - w).abs().max()
                         / w.abs().max().clamp(min=1e-30))
                   for n, w in want.items())

    def median_entry(got: dict, want: dict) -> float:
        """The median over weight tensors of the median entry's |diff|
        over the tensor's scale."""
        return statistics.median(
            float((got[n] - w).abs().median() / w.abs().max().clamp(
                min=1e-30)) for n, w in want.items() if w.ndim >= 2)

    def param_share(got: dict, want: dict) -> float:
        """The smallest share of a tensor's entries within
        PARITY_PARAM_LR_FRACTION * lr."""
        return min(float(((got[n] - w).abs() <= cfg.learning_rate
                          * PARITY_PARAM_LR_FRACTION).float().mean())
                   for n, w in want.items())

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    out, pools = {}, {}
    for dev in ("cuda", "cpu"):
        state, b = fresh(dev)
        pools[dev] = []
        with recorded_max_pools(pools[dev]):
            state, metrics = make_train_step(cfg, preprocessing="shift127")(
                state, b)
        out[dev] = (float(metrics["loss_total"]), grads(state),
                    {k: p.detach().cpu()
                     for k, p in state.model.named_parameters()})
    if not (torch.backends.cudnn.allow_tf32
            and torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the parity step did not restore the caller's "
                             "TF32 flags")
    tf32_loss, _ = unscoped()
    control = tf32_backward()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    off_loss, off = unscoped()
    (gpu_loss, gpu, gpu_p), (cpu_loss, cpu, cpu_p) = out["cuda"], out["cpu"]
    if gpu_loss != off_loss or tf32_loss == gpu_loss:
        raise AssertionError(
            f"parity step on the card: loss {gpu_loss} under the policy, "
            f"{off_loss} with TF32 off globally, {tf32_loss} with TF32 on "
            f"and no scope")
    rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    read = dict(card=worst(gpu, off), cpu=median_entry(gpu, cpu),
                params=param_share(gpu_p, cpu_p))
    ctrl = dict(card=worst(control[0], off),
                cpu=median_entry(control[0], cpu),
                params=param_share(control[1], cpu_p))
    failed = [f"{what} {got:.3g} beyond {limit:g}" for what, got, limit in (
        ("loss rel", rel, PARITY_LOSS_RTOL),
        ("gradients vs TF32 off on the card", read["card"],
         PARITY_CARD_GRAD_RTOL),
        ("gradients' median entry vs the cpu", read["cpu"],
         PARITY_CPU_GRAD_MEDIAN)) if not got <= limit]
    if not read["params"] >= PARITY_PARAM_SHARE:
        failed.append(f"updated parameters: a tensor with only "
                      f"{read['params']:.4f} of its entries within "
                      f"{PARITY_PARAM_LR_FRACTION:g} lr")
    if failed:
        raise AssertionError(f"parity step: {'; '.join(failed)}")
    if ctrl["card"] <= PARITY_CARD_GRAD_RTOL \
            or ctrl["cpu"] <= PARITY_CPU_GRAD_MEDIAN:
        raise AssertionError(f"parity step: a backward in TF32 passes the "
                             f"gradient limits ({ctrl}), the trap cannot "
                             f"tell it")
    windows, apart, gap, diff = routed_apart(pools["cuda"], pools["cpu"])
    log("train", f"TF32 trap: parity() step of googlenet_detectnet B=2 "
        f"{NET}x{NET} on the card and the cpu with TF32 allowed by the "
        f"caller, the caller's flags restored after it: loss "
        f"{gpu_loss:.6f} vs {cpu_loss:.6f} (rel {rel:.3g}, limit "
        f"{PARITY_LOSS_RTOL:g}); on the card equal to TF32 off globally, "
        f"{tf32_loss:.6f} with TF32 on and no scope "
        f"(rel {abs(tf32_loss - gpu_loss) / abs(gpu_loss):.3g}); "
        f"gradients vs TF32 off on the card at most {read['card']:.3g} of "
        f"scale (limit {PARITY_CARD_GRAD_RTOL:g}, the control with its "
        f"backward in TF32 {ctrl['card']:.3g}); gradients vs the cpu, "
        f"median entry {read['cpu']:.3g} of scale in the median weight "
        f"tensor (limit {PARITY_CPU_GRAD_MEDIAN:g}, control "
        f"{ctrl['cpu']:.3g}), max|diff| up to {worst(gpu, cpu):.3g} of "
        f"scale; updated parameters, the smallest share within "
        f"{PARITY_PARAM_LR_FRACTION:g} lr {read['params']:.4f} (limit "
        f"{PARITY_PARAM_SHARE:g}, control {ctrl['params']:.4f}); max pools "
        f"but the LRN one: {apart} of {windows} windows routed apart "
        f"between the card and the cpu, top-two gaps up to {gap:.3g} of "
        f"scale, those pools' inputs apart by {diff:.3g} of scale or more "
        f"between the devices")


def train_run(trainer, batch, counters, card: str, what: str) -> dict:
    """TRAIN_WARMUP + TRAIN_STEPS steps of ``trainer`` on one fixed batch,
    counted; then PROFILED_STEPS more under torch.profiler.  Returns the
    state and the run's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from torchfcn.serve.profile import device_rows, range_device_us
    state = trainer.init_state()
    b = trainer.put(batch)
    for fn in counters.values():
        fn.launches = 0
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = trainer.step_fn(state, b)
        trainer.logger.update(state.step, metrics, len(batch["image"]))
        losses.append(metrics["loss_total"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = trainer.step_fn(state, b)
        trainer.logger.update(state.step, metrics, len(batch["image"]))
        losses.append(metrics["loss_total"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: a non-finite loss: {losses}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            state, metrics = trainer.step_fn(state, b)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(us for _, us, _ in rows) / 1e3 / PROFILED_STEPS
    lrn_fwd = sum(us for name, us, _ in rows
                  if "lrn_kernel" in name or "lrn_maxpool_kernel" in name
                  ) / 1e3 / PROFILED_STEPS
    lrn_bwd = sum(range_device_us(prof, f"torchfcn::{plain}_vjp")
                  for plain in ("lrn_across_channels", "lrn_maxpool")
                  ) / 1e3 / PROFILED_STEPS
    row = dict(config=what, batch=len(batch["image"]),
               size=batch["image"].shape[1], steps=TRAIN_STEPS,
               steps_s=TRAIN_STEPS / seconds,
               images_s=TRAIN_STEPS * len(batch["image"]) / seconds,
               busy_ms_step=busy, lrn_forward_ms_step=lrn_fwd,
               lrn_backward_ms_step=lrn_bwd,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               loss_first=losses[0], loss_smoothed=trainer.logger
               .smoothed_loss(), launches=launches)
    if not row["loss_smoothed"] < row["loss_first"]:
        raise AssertionError(f"{what}: the smoothed loss at step "
                             f"{state.step - PROFILED_STEPS} "
                             f"({row['loss_smoothed']}) is not below the "
                             f"first step's ({row['loss_first']})")
    log("train", f"{what} B={row['batch']} {row['size']}x{row['size']} "
        f"bf16 policy: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
        f"{row['steps_s']:.3f} steps/s, {row['images_s']:.1f} images/s "
        f"(host clock, one fixed batch on the card); device busy "
        f"{busy:.3f} ms per step (torch.profiler, {PROFILED_STEPS} steps); "
        f"peak memory {row['peak_mem_gb']:.3f} GiB; loss {losses[0]:.4f} at "
        f"step 1, smoothed {row['loss_smoothed']:.4f} over the last 20; "
        f"launches {launches}; on {card}")
    top = sorted(rows, key=lambda r: -r[1])[:TRAIN_TOP]
    log("train", f"{what}: the {TRAIN_TOP} entries with the most device "
        f"time per step: " + "; ".join(
            f"{us / 1e3 / PROFILED_STEPS:.3f} ms x{count / PROFILED_STEPS:g} "
            f"{name[:60]}" for name, us, count in top))
    return state, row


def phase_train(rng, counters, card: str) -> list:
    """The training path; returns its rows (the GoogLeNet row first)."""
    import tempfile

    from torchfcn import recipes
    from torchfcn.core.config import GridConfig, TrainConfig
    from torchfcn.serve.detector import Detector
    from torchfcn.models import build as build_model
    from torchfcn.serve.profile import bias_heads
    from torchfcn.train.trainer import Trainer, load_snapshot_params
    check_op_gradients(rng)
    parity_step(rng)

    snapdir = tempfile.mkdtemp(prefix="torchfcn_snap_")
    cfg = TrainConfig(grid=GridConfig(NET, NET, 16, 4),
                      model="googlenet_detectnet", snapshot_dir=snapdir,
                      snapshot_every=0, log_every=10 ** 9)
    trainer = Trainer(cfg, device="cuda", log_sink=lambda line: None)
    state, row = train_run(trainer, train_batch(rng, BATCH, NET, 4),
                           counters, card, "googlenet_detectnet")
    steps = TRAIN_WARMUP + TRAIN_STEPS
    for name in ("lrn", "lrn_maxpool"):
        if row["launches"][name] != steps:
            raise AssertionError(f"train: {name} launched "
                                 f"{row['launches'][name]} times in {steps} "
                                 f"steps, not once per step")
    stem = [f"{m}.{p}" for m in ("conv1", "conv2_reduce", "conv2")
            for p in ("weight", "bias")]
    grads = dict(state.model.named_parameters())
    dead = [n for n in stem if grads[n].grad is None
            or not bool(grads[n].grad.abs().sum() > 0)]
    if dead:
        raise AssertionError(f"train: no gradient reached {dead}")
    log("train", f"googlenet_detectnet: every parameter of conv1, "
        f"conv2_reduce and conv2 has a non-zero gradient; the LRN kernels' "
        f"forward {row['lrn_forward_ms_step']:.4f} ms per step "
        f"({100 * row['lrn_forward_ms_step'] / row['busy_ms_step']:.2f} % "
        f"of device busy), their plain backward (the device time inside "
        f"the ops' backward ranges) {row['lrn_backward_ms_step']:.4f} ms "
        f"per step "
        f"({100 * row['lrn_backward_ms_step'] / row['busy_ms_step']:.2f} %)")

    # the snapshot round trip: Trainer.save -> Detector.from_checkpoint
    trainer.save(state)
    saved = load_snapshot_params(snapdir)
    step0 = build_model(cfg.model)
    step0.init_weights(torch.Generator().manual_seed(cfg.seed))
    step0 = dict(step0.named_parameters())
    for name, p in state.model.named_parameters():
        if not torch.equal(saved[name], p.detach().cpu()):
            raise AssertionError(f"snapshot: {name} is not the trained one")
        if torch.equal(saved[name], step0[name].detach()):
            raise AssertionError(f"snapshot: {name} still holds its step-0 "
                                 f"value")
    frames = rng.integers(0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)
    loaded = Detector.from_checkpoint(snapdir, "googlenet_detectnet",
                                      max_candidates=K, device="cuda")
    memory = Detector("googlenet_detectnet", max_candidates=K,
                      device="cuda")
    memory.model.load_state_dict(state.model.state_dict())
    for det in (loaded, memory):
        bias_heads(det)
        with torch.no_grad():
            det.model.cvg.bias.fill_(SNAPSHOT_CVG_BIAS)
    a, b = loaded(frames), memory(frames)
    torch.cuda.synchronize()
    if not int(a.valid.sum()):
        raise AssertionError("snapshot round trip: no detection to compare")
    assert_same_result(a, b, "snapshot round trip")
    preset = Detector.from_checkpoint(snapdir, "googlenet_detectnet_serving",
                                      max_candidates=K, device="cuda")
    for name, p in preset.model.named_parameters():
        if not torch.equal(p.detach().cpu(), saved[name].to(p.dtype)):
            raise AssertionError(f"snapshot in the serving preset: {name} "
                                 f"is not the snapshot's")
    res = preset(frames)
    if not bool(torch.isfinite(res.confidence).all()):
        raise AssertionError("snapshot in the serving preset: non-finite")
    log("train", f"snapshot round trip: Trainer.save at step {state.step} "
        f"holds the trained parameters, every one moved from its step-0 "
        f"value; Detector.from_checkpoint equals the in-memory parameters "
        f"({int(a.valid.sum())} detections with the coverage bias at "
        f"{SNAPSHOT_CVG_BIAS:g}); the googlenet_detectnet_serving preset "
        f"loads the same parameters and serves them")

    cfg = recipes.bounding_box(snapshot_dir=snapdir, snapshot_every=0,
                               log_every=10 ** 9)
    trainer = Trainer(cfg, device="cuda", log_sink=lambda line: None)
    net = cfg.grid.im_height
    _, vgg = train_run(trainer, train_batch(rng, cfg.data.batch_size, net,
                                            cfg.grid.num_classes),
                       counters, card, "vgg_detectnet_train bounding_box")
    return [row, vgg]


# the data phase: a synthetic crop library of DATA_CLASSES textures, on noise
# backgrounds; the compositor's configurations (name, net size, batch)
DATA_CROPS, DATA_CLASSES, DATA_CROP_SIZE = 32, 4, (40, 70)
DATA_CONFIGS = (("googlenet_detectnet", NET, 16),
                ("vgg_detectnet_train", 224, 32))
# card against cpu on the same draws: the float image (0..255) within
# DATA_IMAGE_ATOL, except within DATA_REACH pixels (the blur's radius 9 and
# the sharpen's 1) of a pixel whose rendered mask lies within DATA_MASK_TOL
# of 0.5, where the paste's threshold may flip; seg equal except there
DATA_IMAGE_ATOL, DATA_MASK_TOL, DATA_REACH = 2e-2, 1e-4, 10
DATA_CPU_BATCH = 4
# the invariants' tolerance for seg pixels outside their rects, without
# and with the scene transforms (tests/test_device_compositor.py's)
DATA_SEG_TOL = (2, 4)
DATA_COST_BATCHES, DATA_PROFILED, DATA_PROFILED_STEPS = 20, 5, 2
# GoogLeNet trained from the compositor: steps straight from the pipeline,
# then from a DeviceBatchCache of the gates' n_cached batches
DATA_TRAIN_STEPS, DATA_CACHE = 20, 30
# the validation run: vgg_detectnet_train at 224x224, 4 classes, B = 16,
# trained from scratch at lr VAL_LR from a cache of DATA_CACHE batches,
# scored on VAL_IMAGES held-out scenes composed under another seed every
# VAL_EVERY steps; the trained model's mAP must exceed VAL_MAP_LIMIT and the
# step-0 model's must not.  From scratch the held-out mAP leaves 0 only
# after 500-800 steps at lr 1e-4, hence the 1,500 steps; larger rates
# stayed lower or fell back (PERF.md, section 6)
VAL_STEPS, VAL_EVERY, VAL_IMAGES, VAL_BATCH = 1500, 500, 64, 16
VAL_LR, VAL_MAP_LIMIT = 1e-4, 0.1
# the phase's own seed: its crops and scenes do not move with the phases
# before it
DATA_SEED = SEED + 7


def synth_crops(rng) -> tuple:
    """DATA_CROPS object crops of DATA_CLASSES classes, each with its own
    texture family (gradients, stripes, bands, a checker), class 1 with an
    ellipse mask and the others with box masks (examples/demo.py's
    dataset, drawn with numpy)."""
    imgs, masks, labels = [], [], []
    for i in range(DATA_CROPS):
        c = i % DATA_CLASSES
        h, w = (int(v) for v in rng.integers(*DATA_CROP_SIZE, 2))
        gy, gx = np.mgrid[0:h, 0:w]
        tex = (np.stack([220 - gx * 2, 60 + gy * 2,
                         120 + ((gx + gy) % 6) * 18], -1),
               np.stack([40 + ((gx // 4) % 2) * 170, 200 - gy, 60 + gx], -1),
               np.stack([90 + ((gy // 3) % 2) * 140,
                         50 + ((gx + 2 * gy) % 9) * 20, 230 - gx - gy], -1),
               np.stack([30 + ((gx // 6 + gy // 6) % 2) * 200,
                         150 + (gx % 3) * 30, 40 + gy], -1))[c]
        if c == 1:
            mask = ((gy - h / 2 + 0.5) / (h / 2 - 1)) ** 2 + \
                ((gx - w / 2 + 0.5) / (w / 2 - 1)) ** 2 <= 1
        else:
            mask = np.ones((h, w), bool)
        imgs.append(tex.clip(0, 255).astype(np.uint8))
        masks.append(mask)
        labels.append(c)
    return imgs, masks, labels


def data_pipe(lib, bgs, net: int, batch: int, seed: int, device="cuda",
              **kw):
    from torchfcn.core.config import DataConfig, GridConfig
    from torchfcn.data.device_compositor import DeviceCompositePipeline
    return DeviceCompositePipeline(
        lib, bgs, GridConfig(net, net, 8, DATA_CLASSES),
        DataConfig(batch_size=batch), seed=seed, device=device, **kw)


@contextlib.contextmanager
def caller_tf32():
    """TF32 on for cuDNN convolutions and for matmuls, as a caller has it
    who keeps PyTorch's cuDNN default and sets matmul precision 'high';
    off again when the scope closes, as main() sets it."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        if not (torch.backends.cudnn.allow_tf32
                and torch.backends.cuda.matmul.allow_tf32):
            raise AssertionError("data: this PyTorch build did not take the "
                                 "TF32 flags")
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def compositor_scopes_removed():
    """The compositor's exact-float32 scopes made no-ops: its products and
    convolutions run as the caller's flags say."""
    from torchfcn.data import device_compositor
    exact = device_compositor.float32_exact
    device_compositor.float32_exact = contextlib.nullcontext
    try:
        yield
    finally:
        device_compositor.float32_exact = exact


def card_against_cpu(lib, bgs, net: int, batch: int) -> dict:
    """One set of draws made on the cpu, composed on the cpu and on the card
    with the caller's TF32 on; held to the DATA_* limits above.  A control
    composes the same draws on the card with the compositor's exact-float32
    scopes made no-ops: its float image must differ from the cpu's by more
    than DATA_IMAGE_ATOL, or this check could not see a missing scope."""
    import torch.nn.functional as F
    cpu = data_pipe(lib, bgs, net, batch, SEED + 10, device="cpu")
    card = data_pipe(lib, bgs, net, batch, SEED + 10)
    draws = cpu.draw(batch)
    want = cpu.compose(draws, checks=True)
    with caller_tf32():
        got = {k: v.cpu() for k, v in card.compose(draws.to("cuda"),
                                                   checks=True).items()}
        with compositor_scopes_removed():
            control = card.compose(draws.to("cuda"), checks=True)
            control = control["image_float"].cpu()
    for k in ("rects", "labels", "valid"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"data: card and cpu {k} differ")
    near = want["mask_margin"] < DATA_MASK_TOL
    seg_off = (got["seg"] != want["seg"]) & ~near
    reach = F.max_pool2d(near.float()[:, None], 2 * DATA_REACH + 1, 1,
                         DATA_REACH)[:, 0] > 0

    def away(image):
        err = (image - want["image_float"]).abs()
        return float(torch.where(reach[..., None], 0.0, err).max()), err

    worst, err = away(got["image_float"])
    control_worst, _ = away(control)
    if int(seg_off.sum()) or not worst <= DATA_IMAGE_ATOL:
        raise AssertionError(
            f"data: card against cpu at {net}x{net}: {int(seg_off.sum())} "
            f"seg pixels differ away from the mask threshold; float image "
            f"max|diff| {worst:.3g} (atol {DATA_IMAGE_ATOL:g})")
    if not control_worst > DATA_IMAGE_ATOL:
        raise AssertionError(
            f"data: the control without the exact-float32 scopes passes at "
            f"{net}x{net} (max|diff| {control_worst:.3g}, atol "
            f"{DATA_IMAGE_ATOL:g}): the check cannot see a missing scope")
    row = dict(net=net, batch=batch, near_threshold_px=int(near.sum()),
               seg_differ_px=int((got["seg"] != want["seg"]).sum()),
               image_max_abs_err=worst,
               image_max_abs_err_all=float(err.max()),
               control_image_max_abs_err=control_worst,
               u8_differ_share=float((got["image"] != want["image"])
                                     .float().mean()))
    log("data", f"card against cpu, {net}x{net} B={batch}, one set of draws "
        f"made on the cpu, the caller's TF32 on: rects, labels and valid "
        f"equal; "
        f"{row['near_threshold_px']} pixels with a rendered mask within "
        f"{DATA_MASK_TOL:g} of 0.5, {row['seg_differ_px']} seg pixels differ "
        f"(all among them); float image max|diff| {worst:.3g} away from "
        f"them (atol {DATA_IMAGE_ATOL:g}), {row['image_max_abs_err_all']:.3g} "
        f"everywhere; uint8 images differ at "
        f"{100 * row['u8_differ_share']:.4f} % of the values; the control "
        f"without the compositor's exact-float32 scopes {control_worst:.3g}")
    return row


def seg_outside_rects(b: dict, tol: int) -> int:
    """Seg pixels that lie in no valid rect grown by ``tol``."""
    h, w = b["seg"].shape[1:]
    ys = torch.arange(h, device=b["seg"].device)[None, None, :, None]
    xs = torch.arange(w, device=b["seg"].device)[None, None, None, :]
    x, y, rw, rh = (b["rects"][..., i][..., None, None] for i in range(4))
    inside = (xs >= x - tol) & (xs <= x + rw + tol) & (ys >= y - tol) & \
        (ys <= y + rh + tol) & b["valid"][..., None, None]
    return int(((b["seg"] > 0) & ~inside.any(1)).sum())


def check_data_invariants(lib, bgs, net: int, batch: int) -> None:
    """Batches from the card's generator: rects in the frame, seg pixels in
    their rects, pastes' scaled IoU at most 0.05 (transforms off), every
    scene with a paste, the same seed giving the same batch."""
    from torchfcn.ops.boxes import scaled_iou_xywh
    plain = data_pipe(lib, bgs, net, batch, SEED + 20, scene_flip=False,
                      zoom=False, photometric=False).batch(batch)
    full = data_pipe(lib, bgs, net, batch, SEED + 21).batch(batch)
    again = data_pipe(lib, bgs, net, batch, SEED + 21).batch(batch)
    for k in full:
        if not torch.equal(full[k], again[k]):
            raise AssertionError(f"data: the same seed gave another {k}")
    for what, b, tol in (("plain", plain, DATA_SEG_TOL[0]),
                         ("with the transforms", full, DATA_SEG_TOL[1])):
        r, v = b["rects"], b["valid"]
        inside = (r[..., 0] >= 0) & (r[..., 1] >= 0) & \
            (r[..., 0] + r[..., 2] <= net + 1e-3) & \
            (r[..., 1] + r[..., 3] <= net + 1e-3)
        out = seg_outside_rects(b, tol)
        if bool((v & ~inside).any()) or out or not bool(v.any(1).all()):
            raise AssertionError(f"data: {what}: a rect outside the frame, "
                                 f"{out} seg pixels outside their rects, or "
                                 f"a scene without a paste")
    r, v = plain["rects"], plain["valid"]
    iou = scaled_iou_xywh(r[:, :, None], r[:, None, :])
    later = torch.triu(torch.ones(r.shape[1], r.shape[1], dtype=torch.bool,
                                  device=r.device), 1)
    pair = v[:, :, None] & v[:, None, :] & later
    worst = float(torch.where(pair, iou, 0.0).max())
    if worst > 0.05 + 1e-6:
        raise AssertionError(f"data: pastes overlap, scaled IoU {worst}")
    log("data", f"invariants at {net}x{net} B={batch} on the card's "
        f"generator: rects in the frame, seg pixels within their rects "
        f"(tolerance {DATA_SEG_TOL[0]} plain, {DATA_SEG_TOL[1]} with the "
        f"transforms), pastes' scaled IoU at most {worst:.4f} (limit 0.05), "
        f"{float(full['valid'].sum(1).float().mean()):.3f} boxes a scene, "
        f"the same seed gives the same batch")


def compositor_cost(lib, bgs, net: int, batch: int, card: str) -> dict:
    """Device busy and kernel launches per batch (torch.profiler), batches
    per second on the host clock (each run ending in a synchronize); the
    first batch of a pipeline also checked for host synchronisation."""
    from torch.profiler import ProfilerActivity, profile

    from torchfcn.serve.profile import device_rows
    pipe = data_pipe(lib, bgs, net, batch, SEED + 30)
    for _ in range(WARMUP):
        pipe.batch(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.batch(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DATA_COST_BATCHES):
        pipe.batch(batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DATA_PROFILED):
            pipe.batch(batch)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    row = dict(net=net, batch=batch,
               busy_ms=sum(us for _, us, _ in rows) / 1e3 / DATA_PROFILED,
               launches=sum(n for _, _, n in rows) / DATA_PROFILED,
               batches_s=DATA_COST_BATCHES / seconds,
               host_ms=seconds / DATA_COST_BATCHES * 1e3)
    top = sorted(rows, key=lambda r: -r[1])[:5]
    log("data", f"compositor {net}x{net} B={batch} (S=3, T=100): no host "
        f"synchronisation in a batch (sync debug mode 'error'); device busy "
        f"{row['busy_ms']:.3f} ms per batch with {row['launches']:.0f} "
        f"kernels and copies (torch.profiler, {DATA_PROFILED} batches); "
        f"{row['batches_s']:.2f} batches/s, {row['host_ms']:.3f} ms per "
        f"batch (host clock, {DATA_COST_BATCHES} batches) on {card}; most "
        f"device time: " + "; ".join(
            f"{us / 1e3 / DATA_PROFILED:.3f} ms x{n / DATA_PROFILED:g} "
            f"{name[:50]}" for name, us, n in top))
    return row


def composed(pipe, batch: int):
    """The pipeline's batches, each composed inside a "compositor" profiler
    range."""
    from torch.profiler import record_function
    while True:
        with record_function("compositor"):
            b = pipe.batch(batch)
        yield b


def timed_steps(trainer, state, it, counters) -> tuple:
    """DATA_TRAIN_STEPS steps of the Trainer from ``it`` after a warm-up
    ``fit`` of TRAIN_WARMUP steps, counted, then DATA_PROFILED_STEPS
    profiled; returns the state and the run's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from torchfcn.serve.profile import device_rows, range_device_us
    state = trainer.fit(it, max_iter=state.step + TRAIN_WARMUP, state=state,
                        resume=False)

    def steps(n):
        nonlocal state
        for _ in range(n):
            state, metrics = trainer.step_fn(state, trainer.put(next(it)))
        return metrics

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = steps(DATA_TRAIN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: fn.launches / DATA_TRAIN_STEPS for n, fn in
                counters.items()}
    if not np.isfinite(float(metrics["loss_total"])):
        raise AssertionError("data: a non-finite loss")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(DATA_PROFILED_STEPS)
        torch.cuda.synchronize()
    busy = sum(us for _, us, _ in device_rows(prof)) / 1e3 \
        / DATA_PROFILED_STEPS
    comp = range_device_us(prof, "compositor") / 1e3 / DATA_PROFILED_STEPS
    batch = trainer.cfg.data.batch_size
    return state, dict(steps_s=DATA_TRAIN_STEPS / seconds,
                       images_s=DATA_TRAIN_STEPS * batch / seconds,
                       busy_ms_step=busy, compositor_ms_step=comp,
                       launches_per_step=launches)


def check_composed_lrn(trainer, state, it, batch: int) -> tuple:
    """One step of the Trainer from ``it`` with the inputs of its LRN layers
    recorded; each LRN kernel held against its plain version on the
    recorded input, within check_lrn_outputs' bounds (phase_kernels'), and
    its instance checked.  Returns the state and the numbers."""
    from torchfcn.models import layers
    from torchfcn.ops.caffe_layers import lrn_across_channels
    from torchfcn.ops.cuda.lrn import vector_instance
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool
    plains = {"lrn_cuda": ("lrn", lrn_across_channels),
              "lrn_maxpool_cuda": ("lrn_maxpool", lrn_maxpool)}
    calls = {fn: [] for fn in plains}
    with recorded_calls(layers, "lrn_cuda", calls["lrn_cuda"]), \
            recorded_calls(layers, "lrn_maxpool_cuda",
                           calls["lrn_maxpool_cuda"]):
        state, _ = trainer.step_fn(state, trainer.put(next(it)))
    out = {}
    for fn, (name, plain) in plains.items():
        if len(calls[fn]) != 1:
            raise AssertionError(f"data: {len(calls[fn])} {name} layers ran "
                                 f"in a composed step, not one")
        args = dict(calls[fn][0])
        x = args.pop("x").detach()
        if x.shape[0] != batch or not vector_instance(x.dtype, x.shape[-1],
                                                      x.data_ptr()):
            raise AssertionError(f"data: {name} ran on {tuple(x.shape)} "
                                 f"{x.dtype}, not B = {batch} in the vector "
                                 f"instance")
        with torch.no_grad():
            got, want = getattr(layers, fn)(x, **args), plain(x, **args)
        torch.cuda.synchronize()
        what = f"{name} {tuple(x.shape)} {x.dtype} of a composed step"
        err = check_lrn_outputs(got, want, x.dtype, what)
        out[name] = dict(shape=list(x.shape), dtype=str(x.dtype),
                         max_abs_err=err,
                         bit_equal_share=float((got == want).float().mean()))
        log("data", f"{what}: the kernel against its plain version, max|err| "
            f"{err:.3g}, {100 * out[name]['bit_equal_share']:.4f} % "
            f"bit-equal")
    return state, out


def train_from_compositor(lib, bgs, counters, card: str) -> dict:
    """googlenet_detectnet B = 16 448x448 bf16 policy fed by the
    compositor: straight from the pipeline, then from a cache of
    DATA_CACHE batches; each LRN kernel must launch once a step and is
    held against its plain version on a composed step's inputs."""
    import tempfile

    from torchfcn.core.config import DataConfig, GridConfig, TrainConfig
    from torchfcn.data.pipeline import DeviceBatchCache
    from torchfcn.train.trainer import Trainer
    name, net, batch = DATA_CONFIGS[0]
    cfg = TrainConfig(grid=GridConfig(net, net, 16, DATA_CLASSES), model=name,
                      data=DataConfig(batch_size=batch),
                      snapshot_dir=tempfile.mkdtemp(prefix="torchfcn_data_"),
                      snapshot_every=0, log_every=10 ** 9)
    trainer = Trainer(cfg, device="cuda", log_sink=lambda line: None)
    pipe = data_pipe(lib, bgs, net, batch, SEED + 40)
    piped_it = composed(pipe, batch)
    state, piped = timed_steps(trainer, trainer.init_state(), piped_it,
                               counters)
    state, lrn_checked = check_composed_lrn(trainer, state, piped_it, batch)
    cache = DeviceBatchCache(trainer.put, composed(pipe, batch), DATA_CACHE)
    first = cache.batches[0]["image"]
    if trainer.put(cache.batches[0])["image"].data_ptr() != first.data_ptr():
        raise AssertionError("data: Trainer.put copied a batch on the card")
    state, cached = timed_steps(trainer, state, iter(cache), counters)
    for what, row in (("from the pipeline", piped), ("from the cache",
                                                     cached)):
        for k in ("lrn", "lrn_maxpool"):
            if row["launches_per_step"][k] != 1:
                raise AssertionError(
                    f"data: {k} launched {row['launches_per_step'][k]} "
                    f"times a step {what}, not once")
        log("data", f"{name} B={batch} {net}x{net} bf16 policy trained "
            f"{what}: {row['steps_s']:.3f} steps/s, {row['images_s']:.1f} "
            f"images/s (host clock, {DATA_TRAIN_STEPS} steps); device busy "
            f"{row['busy_ms_step']:.3f} ms per step, the compositor "
            f"{row['compositor_ms_step']:.3f} ms of it "
            f"({100 * row['compositor_ms_step'] / row['busy_ms_step']:.2f} "
            f"%); launches per step {row['launches_per_step']}; on {card}")
    return dict(config=name, batch=batch, size=net, from_pipeline=piped,
                from_cache=cached, lrn_against_plain=lrn_checked)


def validation_run(lib, counters, card: str) -> dict:
    """vgg_detectnet_train 224x224 with 4 classes trained from a cache of
    composed scenes, scored by detection_validator every VAL_EVERY steps;
    the trained mAP must exceed VAL_MAP_LIMIT and the step-0 mAP must
    not.  Then the trained model is scored once more with the NMS inputs
    recorded, and the groupRectangles kernel is held against its plain
    version on those of the first chunk."""
    import tempfile

    from torchfcn.core.config import DataConfig, GridConfig, TrainConfig
    from torchfcn.data.pipeline import DeviceBatchCache
    from torchfcn.models import build as build_model
    from torchfcn.serve import detector as detector_module
    from torchfcn.train.trainer import Trainer
    from torchfcn.train.validate import detection_validator, \
        val_set_from_compositor
    name, net = "vgg_detectnet_train", 224
    kwargs = {"num_classes": DATA_CLASSES}
    rng = np.random.default_rng(SEED + 50)
    bgs = rng.integers(0, 70, (8, net, net, 3)).astype(np.float32)
    held = data_pipe(lib, bgs, net, VAL_BATCH, SEED + 51)
    images, gts, _ = val_set_from_compositor(held, VAL_IMAGES)
    validator = detection_validator(name, images, gts, model_kwargs=kwargs)
    cfg = TrainConfig(grid=GridConfig(net, net, 8, DATA_CLASSES), model=name,
                      data=DataConfig(batch_size=VAL_BATCH),
                      learning_rate=VAL_LR, max_iter=VAL_STEPS,
                      eval_every=VAL_EVERY, snapshot_every=0,
                      snapshot_dir=tempfile.mkdtemp(prefix="torchfcn_val_"),
                      log_every=10 ** 9)
    trainer = Trainer(cfg, model=build_model(name, **kwargs),
                      validator=validator, device="cuda",
                      log_sink=lambda line: None)
    state = trainer.init_state()
    state.model.eval()
    with torch.no_grad(), state.policy.precision():
        step0 = validator(state.model)
    state.model.train()
    cache = DeviceBatchCache(trainer.put, iter(data_pipe(
        lib, bgs, net, VAL_BATCH, SEED + 52)), DATA_CACHE)
    counters["group_rects"].launches = 0
    t0 = time.perf_counter()
    trainer.fit(iter(cache), state=state, resume=False)
    seconds = time.perf_counter() - t0
    history = [{"step": h["step"], "mAP": h["val_mAP"],
                "n_det": h["val_n_det"]} for h in trainer.logger.history
               if "val_mAP" in h]
    row = dict(config=name, size=net, batch=VAL_BATCH, steps=VAL_STEPS,
               lr=VAL_LR, val_images=VAL_IMAGES,
               n_gt=int(sum(len(g[1]) for g in gts)),
               step0=step0, history=history, limit=VAL_MAP_LIMIT,
               fit_s=seconds,
               group_rects_per_validation=counters["group_rects"].launches
               / len(history))
    log("data", f"validation: {name} {net}x{net} {DATA_CLASSES} classes B="
        f"{VAL_BATCH} lr {VAL_LR:g}, {VAL_STEPS} steps from a cache of "
        f"{DATA_CACHE} composed batches in {seconds:.1f} s, scored every "
        f"{VAL_EVERY} steps on {VAL_IMAGES} held-out scenes "
        f"({row['n_gt']} boxes) composed under another seed: step 0 mAP "
        f"{step0['mAP']} ({step0['n_det']} detections), then "
        + ", ".join(f"{h['step']}: {h['mAP']} ({h['n_det']})"
                    for h in history)
        + f"; limit {VAL_MAP_LIMIT}; groupRectangles launched "
        f"{row['group_rects_per_validation']:g} times a validation; on "
        f"{card}")
    if not step0["mAP"] < VAL_MAP_LIMIT < history[-1]["mAP"]:
        raise AssertionError(
            f"data: held-out mAP {step0['mAP']} at step 0 and "
            f"{history[-1]['mAP']} after {VAL_STEPS} steps do not straddle "
            f"the limit {VAL_MAP_LIMIT}")
    calls = []
    state.model.eval()
    with recorded_calls(detector_module, "vote_boxes_batched", calls), \
            torch.no_grad(), state.policy.precision():
        validator(state.model)
    nms = calls[0]
    rects = nms["propose_boxes"].float().contiguous().clone()
    valid = nms["valid"].contiguous().clone()
    if not bool(valid.any()):
        raise AssertionError("data: the trained validator's first chunk has "
                             "no valid NMS candidate")
    row["group_rects_against_plain"] = dict(
        shape=list(rects.shape), valid_candidates=int(valid.sum()),
        **check_group_rects(rects, valid, f"the trained validator's first "
                            f"chunk ({int(valid.sum())} valid candidates)",
                            timed=False, group_threshold=nms["group_threshold"],
                            eps=nms["eps"]))
    return row


def phase_data(counters, card: str) -> dict:
    """Training from scenes composed on the card; returns its numbers."""
    from torchfcn.data.device_compositor import CropLibrary
    t0 = time.perf_counter()
    rng = np.random.default_rng(DATA_SEED)
    lib = CropLibrary.from_arrays(*synth_crops(rng))
    bgs = {net: rng.integers(0, 70, (8, net, net, 3)).astype(np.float32)
           for _, net, _ in DATA_CONFIGS}
    out = dict(card_vs_cpu=[], cost=[])
    seconds = {}
    for _, net, batch in DATA_CONFIGS:
        t = time.perf_counter()
        out["card_vs_cpu"].append(card_against_cpu(lib, bgs[net], net,
                                                   DATA_CPU_BATCH))
        seconds[f"card_vs_cpu_{net}"] = time.perf_counter() - t
        check_data_invariants(lib, bgs[net], net, batch)
        out["cost"].append(compositor_cost(lib, bgs[net], net, batch, card))
    t = time.perf_counter()
    out["train"] = train_from_compositor(lib, bgs[DATA_CONFIGS[0][1]],
                                         counters, card)
    seconds["train"] = time.perf_counter() - t
    t = time.perf_counter()
    out["validation"] = validation_run(lib, counters, card)
    seconds["validation"] = time.perf_counter() - t
    out["seconds"] = dict(seconds, phase=time.perf_counter() - t0)
    log("data", f"phase took {out['seconds']['phase']:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from torchfcn.ops.cuda import build
    from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
    from torchfcn.ops.cuda.lrn import lrn_cuda
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda
    from torchfcn.ops.cuda.stem import stem_tail_cuda

    # the float32 plain versions and the parity phase run full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    print(card, flush=True)

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    log("build", f"{path.name} in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(SEED)
    rows = phase_kernels(rng)
    phase_parity(rng)
    counters = {"group_rects": group_rectangles_cuda, "lrn": lrn_cuda,
                "lrn_maxpool": lrn_maxpool_cuda}
    launches, row = phase_main_path(rng, counters, card)
    rows["group_rects"].update(row, library_ms=None)
    counters["stem_tail"] = stem_tail_cuda
    launches["stem_tail"] = phase_serving(rng, counters, card)["stem_tail"]
    families, big = phase_families(rng, counters, card)
    rows["group_rects"].update(big)
    train = phase_train(rng, counters, card)
    data = phase_data(counters, card)

    meta = {
        "group_rects": ("torchfcn/csrc/group_rects.cu",
                        "tpufcn/ops/pallas/group_rects.py:166"),
        "lrn": ("torchfcn/csrc/lrn.cu", "tpufcn/ops/pallas/lrn.py:38"),
        "lrn_maxpool": ("torchfcn/csrc/lrn.cu",
                        "tpufcn/ops/pallas/lrn_pool.py:94"),
        "stem_tail": ("torchfcn/csrc/stem.cu",
                      "tpufcn/ops/pallas/stem.py:126"),
    }
    per_step = train[0]["launches"]
    composed_step = data["train"]["from_pipeline"]["launches_per_step"]
    kernels = [dict(name=name, route="cuda", source=meta[name][0],
                    replaces=meta[name][1], launches=launches[name],
                    train_launches_per_step=per_step[name] / (
                        TRAIN_WARMUP + TRAIN_STEPS),
                    composed_train_launches_per_step=composed_step[name],
                    validation_launches=data["validation"][
                        "group_rects_per_validation"]
                    if name == "group_rects" else 0,
                    **rows[name]) for name in counters]
    print(json.dumps({"card": card, "families": families}), flush=True)
    print(json.dumps({"card": card, "train": train}), flush=True)
    print(json.dumps({"card": card, "data": data}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
