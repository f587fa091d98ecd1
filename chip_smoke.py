#!/usr/bin/env python3
"""Smoke run of the torchfcn serving and training paths on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero.
TF32 is off throughout (but for the TF32 trap of phase 9), so the float32
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
7. stream: the stream serving surface (``torchfcn.serve``).  The flagship
   launch graph (a DetectorNode of googlenet_detectnet, bf16, K = 256, the
   heads biased, micro-batch 8, flush after 50 ms) replays 61 seeded
   448x448 frames (a part-filled tail) and 16 of 640x480 (a geometry
   flush): each kernel of the path launched once in every dispatch, every
   published RectsMsg equal to one built from a direct Detector call on
   the same padded batch, stamps in order; the googlenet_detectnet_serving
   graph the same way, the stem tail once a dispatch.  The same graph in
   float32 on the card and on the CPU on 8 frames: heads within 1e-3, the
   card's rects equal to decode + NMS on the CPU of its heads.  The LRN
   kernels and groupRectangles against their plain versions on the inputs
   of the flagship node's last dispatch: bit-equal and exact.  Timings on
   the card's name and power limit: node latency percentiles at micro-
   batch 1 and 8, replay_throughput at micro-batch 8 and 32 over 256
   frames from host memory, a dispatch's device busy time against its
   wall time.  The TCP bus: the native broker built from
   ``torchfcn/netbus/broker.cpp``, a publisher process that imports
   ``torchfcn.serve.netbus`` alone (no jax; torch only when it unpickles
   the first RectsMsg) sending 32 raw-encoded frames a micro-batch at a
   time, the node here on a RemoteTopicBus: rects equal to the in-process
   run's.  Export: both graphs' Detectors through
   ``export_detector`` at B = 8, loaded in a fresh process without the
   model zoo and run on the card: results equal to the Detectors', all
   four kernels launched.  The tiled fcn32s_seg + point-map graph of
   ``examples/fcn_point_map.launch.json`` in float32 on a 480x640 frame
   and a synthetic organized cloud: the card's pmap equal to the CPU's
   but at a share of values off by one (STREAM_PMAP_OFF_BY_ONE), boxes and
   clusters equal.  ``torchfcn.entry.entry()``: fn(*args) on the card
   equals the Detector;
8. families: the VGG, FCN and ResNet-FPN families.  First, once per
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
9. train: the input gradients through the lrn and lrn_maxpool custom ops
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
10. data: training from scenes composed on the card
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
   validator's candidates of one chunk;
11. gates: the accuracy gates (``torchfcn.train.gates``) at their capture
   configurations on the hard benchmark's sources rendered on the host
   (timed): the VGG16 pretrain at its capture shape for
   GATE_PRETRAIN_STEPS steps (its loss at the end below step 1's), its
   export loaded by name into vgg_pyramid_detectnet with every backbone
   conv bit-equal to the classifier's; ``segmentation_gate`` of
   fcn32s_seg (exact and e5m2 mIoU, the exact one above GATE_MIOU_LIMIT
   and the untrained model's below it); ``detection_gate`` of
   googlenet_detectnet_3cls (exact and e5m2 mAP, detections, the exact
   mAP above GATE_MAP_LIMIT and step 0's below it), each LRN kernel
   launched once a training step, groupRectangles once a scoring chunk
   and held against its plain version on the trained model's first
   chunk, the stem tail once an e5m2 scoring chunk; and the gate step's
   device busy time with the LRN ops' plain backward's share;
12. mesh: the (data, space) mesh on torch.distributed. The stem-tail kernel
   on row shards (halo rows above and below read as data) against its plain
   version with the same arguments at the row-sharded serving path's three
   shard shapes, to the stem tail's bounds, timed at rank 0's. NCCL at
   world size 1 on a 1 x 1 mesh, its collectives called: a parity() train
   step of googlenet_detectnet at B = 16, 448x448, dropout on, equal to the
   mesh=None step within the parity step's limits, and the flagship
   Detector (bf16, K = 256) equal to mesh=None's. Two processes sharing the
   card over gloo (NCCL refuses one GPU twice): a (data=2) train step
   against the one-process step (gradients by the parity step's card-vs-CPU
   median rule: a batch shard's activations may round elsewhere), and the
   (space=2) bf16 and e5m2 Detectors and the (data=2) Detector, each on 8
   448x448 frames: every rank returns the same global result; against the
   one process (mesh=None, in rank 0's process, the 8 frames in two calls
   of 4: each rank's problem size, by which cuDNN picks its bf16
   algorithms) the heads within MESH_HEAD_TOL, the result equal, integers
   and confidences exactly, to decode + NMS of its own heads, and to the
   one process's result where the heads are bit-equal (else the share of
   equal entries is printed); the share of entries equal to one call of all
   8 frames is printed (a box near a rounding edge moves by one when the
   convs round elsewhere). In the same two processes, every other family
   row-sharded over (space=2), bf16, 8 frames, K = 256 (MESH_FAMILIES):
   fcn8s_bbox and its e5m2 preset at 288x288 (bands 160 + 128 rows),
   vgg_pyramid_detectnet and resnet_fpn_detectnet at 448x448,
   googlenet_detectnet and its preset on 432 rows (bands 224 + 208, the LRN
   kernels and the stem tail on a band that is not half the frame): every
   rank the same result, the heads within MESH_HEAD_TOL of the one
   process's (two calls of 4), the result equal to decode + NMS on the CPU
   of the meshed heads and, where the heads are bit-equal, to the one
   process's; the float32 heads (TF32 off) of each family but the presets
   within 1e-5 of the one process's; every kernel launched on every rank
   and held against its plain version on its recorded inputs; the halo,
   all-reduce and gather shares of each call. The float32 parity steps (B =
   4, dropout on) of resnet_fpn_detectnet at 448x448 and fcn8s_bbox at
   288x288 with its seg loss, row-sharded, against the one process
   (MESH_SPACE_GRAD_MEDIAN), each with a control (each band's GroupNorm
   statistics its own; zero-filled halos) that must fail. And in this
   process: whether cuDNN's deterministic=True, benchmark=False makes one
   googlenet_detectnet call of 8 frames bit-equal to two of 4, and its
   device-time cost; and the device time of resnet_fpn_detectnet's bf16
   forward with the port's GroupNorm against F.group_norm. Prints the halo
   exchange's share of a row-sharded Detector call, and the step time of
   the one process, of the NCCL 1 x 1 mesh and of 2 gloo ranks, beside the
   card's name and power limit;
13. records: the record and VOC data path (``torchfcn.data.jpeg``,
   ``records``, ``voc``, ``RecordTrainPipeline``), without cv2. The 144
   JPEGs of ``tests/fixtures/voc_mini`` decoded by the port's codec, their
   pixels' digest equal to cv2's (FIXTURE_DECODE_SHA256), re-encoded at
   quality 95 byte-equal to cv2 (FIXTURE_ENCODE_SHA256) and decoded again,
   the host's milliseconds per image of each; the CLI chain in this
   process: ``voc`` (48 / 96 samples), ``records --format voc`` of both
   splits, ``records --inspect``, ``train --recipe bounding_box --records``
   (B = 32, 224x224, RECORDS_TRAIN_STEPS steps) on the card with one
   validation on ``--val-records`` (groupRectangles twice), ``eval
   --format voc`` of the 96 val images from the snapshot (groupRectangles
   once an image); then ``voc_fixture_gate`` at its capture configuration
   (vgg_detectnet_train 224x224 B = 16, VOC_GATE_STEPS steps from a cache
   of 10 record batches, Adam lr 1e-4; 96 val images at 448x448 with 168
   boxes): its mAP above VOC_MAP_LIMIT and the untrained net's below it,
   groupRectangles once a scoring chunk of 8 and held against its plain
   version on the trained net's first chunk, exactly, and timed there; the
   gate's training step profiled (device busy against the wall per step);
14. tools: the label tools (``torchfcn.tools``), whose CNN codes run VGG16
   on the card and none of the four kernels (the launches are printed).
   The 168 ground-truth crops of the fixture's 96 val images: the
   extractor's float32 codes at 224x224 (TF32 off) within TOOLS_CODE_ATOL
   of the CPU's on the same resized batch, and its bf16 codes at a cosine
   of at least TOOLS_MIN_COSINE with the float32 ones, each with controls
   that must miss its bound (TF32 on; the bf16 codes' rows permuted, and
   the bf16 code of the largest crop with its pixel rows shuffled);
   ``cli refine`` over 32 seeded 480x640 frames of a textured object
   moving 3-8 px a frame (two of them occluded) and ``cli rank`` over a
   manifest of the 168 crops, each in float32 on the card and on the CPU,
   the manifests equal line for line; a launch graph of a capture, a
   boundary_refinement and a roi_classifier node (its head fitted to the
   crops' float32 CPU codes and their 3 labels) over 8 fixture frames,
   float32 on the card and on the CPU, each frame's boxes published as a
   RectsMsg and its first box on /object_rect: the JPEGs written
   byte-equal to ``jpeg.encode`` of each frame, the refined rects equal to
   the CPU graph's, the kept proposals' rects and labels equal to the CPU
   graph's and their probabilities within TOOLS_PROB_ATOL, at least one
   proposal kept; codes per second, the host's resize and device busy
   per call at B = 1, 16 and 168 in bf16 and float32, ncc_track's host ms
   per 480x640 frame pair, and each stage's wall;
15. compositor: the host compositor (``torchfcn.data.compositor``, numpy,
   no cv2) on the card's host.  ``hard_pipeline``'s first batch at
   448x448 (B = 16, seed 1) must hash to COMPOSITOR_DIGEST, the digest the
   CPU tests record, so that the card's host composes the scenes the CPU
   tests compose; host ms per batch and per scene (median of 4 batches)
   and per scene at 224x224 and 288x288; ``cli train --manifest`` (no
   --device-data) on the card from the hard sources written as PNGs, 20
   steps of B = 8 under torch.profiler (finite losses, steps/s and the
   device's idle share over the command and over the Trainer's loop); the
   googlenet_3cls gate unit in the JAX package's
   own mode (its capture configuration, host-cached training scenes, the
   host held-out set), exact and e5m2, past HOST_GATE_MAP_LIMIT with the
   untrained net below it, each kernel against its plain version on its
   scoring's recorded inputs, the JAX package's recorded reading printed
   beside it as a reference;
16. inputs: the host worker pool, e5m2 storage without store_stem2 and
   camera recordings.  ``ParallelCompositePipeline`` (spawned workers, in
   fresh ``python -c`` processes, whose children import no main script, as
   under ``python -m torchfcn.cli``) over the hard sources written as PNGs:
   2 workers at 64x64, B = 2, each batch received by digest the next batch
   of exactly one worker's serial ``CompositeTrainPipeline(seed + 1000 *
   w)``, both workers sending; scenes/s of a serial pipeline and of pools
   of 1, 2, 4 and 8 workers at 448x448, B = 8 (the first batch's wait
   apart); ``cli train --manifest --workers 8`` at phase 15's settings
   under torch.profiler (steps/s and the device's idle share over the
   command and over the Trainer's loop, beside phase 15's in-process
   reading); a worker's missing file relayed as RuntimeError; no process
   left after any pool's close().
   ``Detector("googlenet_detectnet", model_kwargs={"store_dtype": e5m2})``
   (store_stem2 off) on 8 seeded 448x448 frames: lrn, lrn_maxpool and
   groupRectangles once each, the stem tail never, LRN1's input e5m2
   values, both LRN kernels against their plain versions on their recorded
   inputs, detections equal to decode + NMS of the same heads on the CPU,
   2 frames' heads against the CPU's within STEM2_HEAD_TOL of scale and
   nearer on average than e5m2 storage moves the CPU's heads, latency and
   device busy.  The MJPG fixture (``tests/fixtures/video``) read by
   ``torchfcn.serve.video``: its frames and a copy without Huffman tables
   (``video_without_dht``) against the digests the CPU tests record, its
   stamps, host ms a frame; its frames through the flagship graph (each
   RectsMsg against direct Detector calls, the kernels against their plain
   versions on the last dispatch), ``cli replay --video`` and ``cli launch
   --video --video-stride 2 --max-frames 5`` over the flagship launch file
   with its overlay topic, on weights whose heads fire (stamps published
   at the source's cadence, frames published equal processed, each
   overlay equal to ``viz.draw_detections`` of its frame and the node's
   RectsMsg, the kernels against their plain versions on the graph's last
   dispatch).  The overlay on the host (``torchfcn.serve.viz``): the
   digest of ``draw_detections`` on seeded inputs (all 95 printable
   characters, boxes past the edges, 20 classes) against the one the CPU
   tests record from tpufcn's cv2 drawing, host ms an overlay of a
   448x448 frame with 10 detections; ``cli detect --overlay-dir`` and
   ``cli train --records --inspect-data`` with ``--device cuda``, each
   PNG read back equal to ``draw_detections`` of its frame and boxes.

Then one JSON line of the stream phase's numbers, one of the families'
numbers, one of the training runs' numbers, one of the data phase's, one
of the gates', one of the mesh phase's, one of the records phase's, one
of the tools phase's, one of the compositor phase's, one of the inputs
phase's, one JSON line of per-kernel numbers (with each
kernel's launches per dispatch of the stream graphs, per training step,
per step fed by the compositor, per validation, per gate training step
and per gate scoring, per rank in each run of the mesh phase, in the
records chain's training and eval and per voc_fixture scoring, in the
e5m2 batch without store_stem2 and per dispatch of the video replay; the
stem tail on halo rows as a row of its own), each kernel's time beside its
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
import os
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


# torch.profiler has now and then come back from a profile of calls that
# launched kernels with no device activity at all (twice so far, each
# time in an early phase; ROADMAP Queue 3 item 4): such a profile is logged and taken again, up to this many times
PROFILE_TRIES = 3


def device_profile(run, what: str) -> tuple:
    """``run()`` and a synchronize under torch.profiler, CPU and CUDA
    activity on; returns the finished profile and its device rows
    (``serve.profile.device_rows``).  A profile with no device row is
    logged and ``run`` is profiled again, PROFILE_TRIES times in all;
    then it raises."""
    from torch.profiler import ProfilerActivity, profile

    from torchfcn.serve.profile import device_rows
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            if attempt > 1:
                log("profile", f"{what}: profile {attempt} of "
                    f"{PROFILE_TRIES} recorded device time")
            return prof, rows
        log("profile", f"{what}: torch.profiler recorded no device time "
            f"(profile {attempt} of {PROFILE_TRIES})")
    raise AssertionError(f"{what}: torch.profiler recorded no device time "
                         f"in {PROFILE_TRIES} profiles")


def busy_ms(fn) -> float:
    """Device time of one call of ``fn``: the device self time of every
    kernel and copy it launches, summed over REPS calls under torch.profiler
    after WARMUP calls, per call.  Unlike CUDA events around the call, it
    leaves out the device's idle time while the host prepares a launch.
    Where PROFILE_TRIES profiles record no device time, it logs so and
    returns the CUDA-event time of ``median_ms`` instead."""
    what = f"{fn.__qualname__} (chip_smoke.py:{fn.__code__.co_firstlineno})"
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(REPS):
            fn()

    try:
        _, rows = device_profile(calls, what)
    except AssertionError as e:
        log("profile", f"{e}; timed by CUDA events instead")
        return median_ms(fn)
    return sum(us for _, us, _ in rows) / 1e3 / REPS


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


def check_stem_outputs(got, want, store, what: str) -> tuple:
    """The stem tail's bounds against its plain version: bf16 within
    STEM_ATOL or 2 ulps, e5m2 within one e5m2 step, and at least 99.9 %
    bit-equal; returns (max |err|, bit-equal share)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    err = (g - w).abs()
    equal = float((g == w).float().mean())
    if store is None:
        bad = err > torch.clamp(2 * bf16_ulp(w), min=STEM_ATOL)
    else:
        bad = e5m2_steps(got, want) > 1
    if bool(bad.any()) or equal < 0.999:
        raise AssertionError(
            f"{what}: {int(bad.sum())} entries beyond tolerance, "
            f"{equal:.6f} bit-equal; got {g[bad][:5].tolist()} want "
            f"{w[bad][:5].tolist()}")
    return float(err.max()), equal


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
            max_err, equal = check_stem_outputs(got, want, arg,
                                                f"stem_tail {shape} {store}")
            msg = f"stem_tail {shape} {store}: max|err| " \
                f"{max_err:.3g}, {equal * 100:.4f} % bit-equal"
            if shape == STEM_SHAPES[0]:
                ms = busy_ms(lambda: stem_tail_cuda(xs, *weights, arg))
                call_ms = median_ms(lambda: stem_tail_cuda(xs, *weights, arg))
                plain_ms = busy_ms(lambda: stem_tail(xs, *weights, arg))
                msg += f", kernel {ms:.4f} ms (call {call_ms:.4f}), plain " \
                    f"{plain_ms:.4f} ms"
                if arg is not None:   # the serving path's: into the JSON
                    row = dict(max_abs_err=max_err, ms=ms,
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


# the stream phase: the flagship node's micro-batch and deadline; the frames
# it replays (61 of 448x448, so the tail is part-filled when 16 of 640x480
# change the geometry); frames over the TCP bus; the timings' frame counts
STREAM_MICRO_BATCH, STREAM_FLUSH_MS = 8, 50.0
STREAM_SQUARE, STREAM_CAMERA = 61, 16
STREAM_TCP_FRAMES = 32
STREAM_LATENCY_FRAMES, STREAM_THROUGHPUT_FRAMES = 128, 256
# the pmap of the tiled graph, card against the CPU in float32: the share
# of values off by one (tests/test_torch_stream.py's PMAP_OFF_BY_ONE)
STREAM_PMAP_OFF_BY_ONE = 1e-3
# fcn32s_seg's class-1 score bias in the tiled graph, so that its maps
# hold regions (tests/test_torch_stream.py lifts it the same way)
STREAM_SEG_BIAS = 2.6
RECTS_TOPIC = "/fcn_object_detector/rects"


class DispatchLog:
    """The Detector of a DetectorNode, each call (one dispatch) counted on
    its own: every kernel's launch count set to 0 before it and read after
    a synchronize; its padded batch kept with the node's processed count
    before it, so that each dispatch's real frames are known after the
    run."""

    def __init__(self, node, counters):
        self.node, self.det, self.counters = node, node.detector, counters
        self.launches, self.batches, self.before = [], [], []
        self.seconds = []
        node.detector = self

    def __getattr__(self, name):
        return getattr(self.det, name)

    def __call__(self, frames):
        self.before.append(self.node.processed)
        for c in self.counters.values():
            c.launches = 0
        t = time.perf_counter()
        res = self.det(frames)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t)
        self.launches.append({k: c.launches for k, c in
                              self.counters.items()})
        self.batches.append(np.asarray(frames))
        return res

    def real(self) -> list:
        """The real (not padding) frames of each dispatch."""
        marks = self.before + [self.node.processed]
        return [b - a for a, b in zip(marks, marks[1:])]

    def per_dispatch(self, what: str, required, absent=()) -> dict:
        """Launches per dispatch of each kernel; raises unless each kernel
        of ``required`` launched once in every dispatch and those of
        ``absent`` never."""
        for i, row in enumerate(self.launches):
            if any(row[k] != 1 for k in required) or any(row[k]
                                                         for k in absent):
                raise AssertionError(f"{what}: dispatch {i} launched {row}")
        n = len(self.launches)
        return {k: sum(r[k] for r in self.launches) / n
                for k in self.counters}


def rects_msgs(dets_per_frame) -> list:
    """(points, labels, confidences) of each frame's RectsMsg, as
    DetectorNode builds it from ``DetectionResult.to_lists()``."""
    return [([p for box, _, _ in dets for p in ((box[0], box[1]),
                                                (box[2], box[3]))],
             [lab for _, lab, _ in dets], [c for _, _, c in dets])
            for dets in dets_per_frame]


def stream_graph(model: str, bus=None, **params):
    """The flagship launch graph, one detector node (``params`` over the
    flagship's: K = 256, micro-batch 8, flush after 50 ms, bf16 on the
    card) with the heads biased, and the list of rects it publishes as
    (stamp, (points, labels, confidences))."""
    from torchfcn.serve.launch import launch
    from torchfcn.serve.profile import bias_heads
    node_params = dict(model=model, max_candidates=K, device="cuda",
                       micro_batch=STREAM_MICRO_BATCH,
                       flush_after_ms=STREAM_FLUSH_MS)
    node_params.update(params)
    graph = launch({"fcn_object_detector": {
        "type": "detector", "params": node_params,
        "remap": {"image": "image"}}}, bus=bus)
    node = graph.nodes["fcn_object_detector"]
    bias_heads(node.detector)
    out = []
    graph.bus.subscribe(RECTS_TOPIC, lambda m: out.append(
        (m.stamp, (m.data.points, m.data.labels, m.data.confidences))),
        queue_size=1 << 20)
    return graph, node, out


def check_node_against_direct(dlog: DispatchLog, out: list, n: int,
                              what: str) -> int:
    """Every published RectsMsg equals the one built from a direct Detector
    call on the same padded batch, exactly, in order with stamps 0..n-1;
    returns the detections compared."""
    stamps = [s for s, _ in out]
    if stamps != [float(i) for i in range(n)]:
        raise AssertionError(f"{what}: published stamps {stamps[:12]}... "
                             f"are not 0..{n - 1}")
    want = []
    for batch, real in zip(dlog.batches, dlog.real()):
        want += rects_msgs(dlog.det(batch).to_lists())[:real]
    got = [m for _, m in out]
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"{what}: {bad} of {n} RectsMsgs differ from "
                             f"direct Detector calls on the same batches")
    dets = sum(len(m[1]) for m in got)
    if dets == 0:
        raise AssertionError(f"{what}: no detections, nothing was compared")
    return dets


def stream_frames(rng, n: int, hw=(NET, NET)) -> list:
    return list(rng.integers(0, 256, (n,) + hw + (3,), dtype=np.uint8))


def replay_graph(model: str, counters, frames: list, required, absent,
                 what: str, record: bool = False):
    """Replay ``frames`` through a flagship graph of ``model``; each
    published RectsMsg held against direct Detector calls.  Returns (node,
    dispatch log, numbers, the recorded kernel inputs of the last dispatch
    where ``record``)."""
    from torchfcn.models import layers
    from torchfcn.serve import detector
    from torchfcn.serve.stream import replay
    graph, node, out = stream_graph(model)
    dlog = DispatchLog(node, counters)
    calls = {"lrn_cuda": [], "lrn_maxpool_cuda": [],
             "vote_boxes_batched": []}
    with contextlib.ExitStack() as stack:
        if record:
            stack.enter_context(recorded_calls(layers, "lrn_cuda",
                                               calls["lrn_cuda"]))
            stack.enter_context(recorded_calls(
                layers, "lrn_maxpool_cuda", calls["lrn_maxpool_cuda"]))
            stack.enter_context(recorded_calls(
                detector, "vote_boxes_batched",
                calls["vote_boxes_batched"]))
        t0 = time.perf_counter()
        processed = replay(node, frames, bus=graph.bus)
        graph.spin()
        wall = time.perf_counter() - t0
    if processed != len(frames):
        raise AssertionError(f"{what}: {processed} of {len(frames)} frames "
                             f"processed")
    per_dispatch = dlog.per_dispatch(what, required, absent)
    dets = check_node_against_direct(dlog, out, len(frames), what)
    shapes = sorted({b.shape for b in dlog.batches})
    log("stream", f"{what}: {len(frames)} frames in {len(dlog.batches)} "
        f"dispatches of {shapes} (real frames {dlog.real()}), {dets} "
        f"detections, every RectsMsg equal to direct Detector calls on the "
        f"same batches; launches per dispatch {per_dispatch}; replay "
        f"{wall:.2f} s")
    last = {k: v[-1:] for k, v in calls.items()}
    return node, dlog, dict(frames=len(frames), dispatches=len(dlog.batches),
                            real_frames=dlog.real(), detections=dets,
                            launches_per_dispatch=per_dispatch,
                            replay_s=wall), last


def graph_against_cpu(rng) -> dict:
    """The flagship graph in float32 on the card and on the CPU, 8 frames
    each: the heads within 1e-3 (phase_parity's bound), the card node's
    rects equal to decode + NMS on the CPU of the card's heads
    (check_against_cpu's rule), the CPU node's equal to its Detector's."""
    from torchfcn.serve.stream import replay
    frames = stream_frames(rng, STREAM_MICRO_BATCH)
    runs = {}
    for device in ("cuda", "cpu"):
        graph, node, out = stream_graph("googlenet_detectnet", device=device,
                                        dtype="float32")
        replay(node, frames, bus=graph.bus)
        graph.spin()
        runs[device] = (node.detector, [m for _, m in out])
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    x = np.stack(frames)
    with torch.inference_mode():
        heads = card._forward(torch.as_tensor(x, device="cuda"))
        cpu_heads = cpu._forward(torch.from_numpy(x))
        diff = max(float((g.cpu() - c).abs().max())
                   for g, c in zip(heads, cpu_heads))
        want = cpu._decode_nms(*(h.cpu() for h in heads), x.shape[1:3])
    if not diff <= 1e-3:
        raise AssertionError(f"stream f32 graph: heads differ by {diff}")
    if runs["cuda"][1] != rects_msgs(want.to_lists()):
        raise AssertionError("stream f32 graph: the card node's rects differ "
                             "from decode+NMS on the cpu of its heads")
    if runs["cpu"][1] != rects_msgs(cpu(x).to_lists()):
        raise AssertionError("stream f32 graph: the cpu node's rects differ "
                             "from its Detector's")
    dets = sum(len(m[1]) for m in runs["cuda"][1])
    if dets == 0:
        raise AssertionError("stream f32 graph: no detections")
    log("stream", f"f32 graph card vs cpu on {len(frames)} frames: heads "
        f"max|gpu-cpu| {diff:.3g} (atol 1e-3); the card node's {dets} "
        f"detections equal decode+NMS on the cpu of its heads")
    return dict(frames=len(frames), heads_max_abs_diff=diff, detections=dets)


def stream_kernels(calls: dict, phase: str = "stream",
                   batch: int = STREAM_MICRO_BATCH) -> dict:
    """The kernels against their plain versions on the inputs of the
    flagship node's last dispatch (of ``batch`` frames): groupRectangles
    exactly, both LRN kernels bit-equal (bf16)."""
    out = check_recorded_lrn({k: calls[k] for k in ("lrn_cuda",
                                                    "lrn_maxpool_cuda")},
                             batch, phase, "the node's last dispatch")
    for name, row in out.items():
        if row["bit_equal_share"] != 1.0:
            raise AssertionError(f"{phase}: {name} not bit-equal to its "
                                 f"plain version on the node's last "
                                 f"dispatch")
    # the groupRectangles kernel's inputs, as vote_boxes_batched passes them
    args = dict(calls["vote_boxes_batched"][0])
    rects = args["propose_boxes"].float().contiguous()
    valid = args["valid"].contiguous()
    out["group_rects"] = check_group_rects(
        rects, valid, "the node's last dispatch", timed=False,
        group_threshold=args["group_threshold"], eps=args["eps"])
    out["group_rects"]["shape"] = list(rects.shape)
    out["group_rects"]["valid_candidates"] = int(valid.sum())
    return out


def stream_timings(det, rng, card: str) -> dict:
    """Node latency percentiles at micro-batch 1 and 8, replay_throughput
    at micro-batch 8 and 32 from host memory, and the device busy time of
    one dispatch of 8 frames against its host-clock wall time."""
    from torchfcn.serve.bus import TopicBus
    from torchfcn.serve.stream import DetectorNode, replay, replay_throughput
    frames = stream_frames(rng, STREAM_THROUGHPUT_FRAMES)
    latency = {}
    for mb in (1, STREAM_MICRO_BATCH):
        bus = TopicBus()
        node = DetectorNode(bus, detector=det, micro_batch=mb,
                            flush_after_ms=STREAM_FLUSH_MS if mb > 1
                            else None)
        replay(node, frames[:2 * mb], bus=bus)            # warm-up
        node.latencies_ms.clear()
        replay(node, frames[:STREAM_LATENCY_FRAMES], bus=bus)
        latency[mb] = node.latency_stats()
    throughput = {mb: replay_throughput(det, frames, micro_batch=mb)
                  for mb in (STREAM_MICRO_BATCH, 32)}
    batch = np.stack(frames[:STREAM_MICRO_BATCH])
    busy = busy_ms(lambda: det(batch))
    wall = batch_latency(det, batch) * 1e3
    fmt = ", ".join(f"micro-batch {mb}: p50 {s['p50_ms']:.3f} p90 "
                    f"{s['p90_ms']:.3f} p99 {s['p99_ms']:.3f} ms"
                    for mb, s in latency.items())
    log("stream", f"on {card}: node latency over {STREAM_LATENCY_FRAMES} "
        f"frames ({fmt}); replay_throughput over "
        f"{STREAM_THROUGHPUT_FRAMES} frames from host memory: " + ", ".join(
            f"micro-batch {mb} {t['fps']:.1f} frames/s" for mb, t in
            throughput.items()) + f"; one dispatch of {STREAM_MICRO_BATCH}: "
        f"device busy {busy:.3f} ms of {wall:.3f} ms wall "
        f"({100 * (1 - busy / wall):.1f} % idle)")
    return dict(latency={str(k): v for k, v in latency.items()},
                throughput={str(k): v for k, v in throughput.items()},
                busy_ms_per_dispatch=busy, wall_ms_per_dispatch=wall)


PUBLISHER = r"""
import json, sys, time
import numpy as np
import torchfcn.serve.netbus as netbus
assert "jax" not in sys.modules and "torch" not in sys.modules
address, n, batch, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
frames = np.random.default_rng(seed).integers(0, 256, (n, 448, 448, 3),
                                              dtype=np.uint8)
bus = netbus.RemoteTopicBus(address)
got = []
bus.subscribe("/fcn_object_detector/rects", lambda m: got.append(m.stamp),
              queue_size=n)
time.sleep(0.5)
# each frame raw-encoded (an ndarray payload, no pickle)
assert netbus._encode_payload(frames[0])[0][0] == netbus._ENC_NDARRAY
t0 = time.perf_counter()
sent, round_trips, torch_after = [], [], []
for start in range(0, n, batch):
    t = time.perf_counter()
    for i in range(start, min(n, start + batch)):
        bus.publish("image", frames[i], stamp=float(i))
    sent.append(time.perf_counter() - t)
    deadline = time.time() + 60
    while len(got) < min(n, start + batch) and time.time() < deadline:
        bus.spin_once()
        time.sleep(0.0005)
    round_trips.append(time.perf_counter() - t)
    # unpickling the first RectsMsg imports torchfcn.serve.stream, which
    # defines it (and so torch): that lands in the first round trip
    torch_after.append("torch" in sys.modules)
wall = time.perf_counter() - t0
bus.close()
print(json.dumps({"stamps": got, "seconds": wall, "send_s": sent,
                  "round_trip_s": round_trips, "torch_after": torch_after,
                  "jax_imported": "jax" in sys.modules}))
"""


def stream_tcp(counters, rng_seed: int, local_out: list) -> dict:
    """The native broker built from torchfcn/netbus/broker.cpp; a publisher
    process (torchfcn.serve.netbus alone) sends STREAM_TCP_FRAMES frames,
    a micro-batch at a time; the flagship node runs here on a
    RemoteTopicBus.  Its rects must equal ``local_out``, the in-process
    run's on the same frames."""
    from torchfcn.serve.netbus import RemoteTopicBus, start_broker
    handle = start_broker(native="yes")
    proc = None
    try:
        bus = RemoteTopicBus(handle.address)
        graph, node, out = stream_graph("googlenet_detectnet", bus=bus)
        dlog = DispatchLog(node, counters)
        time.sleep(0.3)                   # the node's SUB reaches the broker
        proc = subprocess.Popen(
            [sys.executable, "-c", PUBLISHER, handle.address,
             str(STREAM_TCP_FRAMES), str(STREAM_MICRO_BATCH), str(rng_seed)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.abspath(__file__))))
        deadline = time.time() + 120
        while node.processed < STREAM_TCP_FRAMES and proc.poll() is None \
                and time.time() < deadline:
            graph.spin()
            time.sleep(0.001)
        stdout, stderr = proc.communicate(timeout=60)
        graph.spin()
        bus.close()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        handle.stop()
    if proc.returncode != 0:
        raise AssertionError(f"stream tcp: the publisher failed:\n{stderr}")
    pub = json.loads(stdout.strip().splitlines()[-1])
    if pub["jax_imported"] or sorted(pub["stamps"]) != [
            float(i) for i in range(STREAM_TCP_FRAMES)]:
        raise AssertionError(f"stream tcp: the publisher saw {pub}")
    if out != local_out:
        raise AssertionError("stream tcp: the node's rects over the TCP bus "
                             "differ from the in-process run's")
    per_dispatch = dlog.per_dispatch("stream tcp",
                                     ("lrn", "lrn_maxpool", "group_rects"))
    log("stream", f"tcp bus (native broker, publisher process without jax; "
        f"torch imported to unpickle the first RectsMsg: "
        f"{pub['torch_after'][0]}): {STREAM_TCP_FRAMES} raw-encoded frames, "
        f"a micro-batch at a time, in {pub['seconds']:.3f} s; per micro-"
        f"batch: sent in "
        + ", ".join(f"{t * 1e3:.1f}" for t in pub["send_s"]) + " ms, rects "
        "back after " + ", ".join(f"{t * 1e3:.1f}" for t in
                                  pub["round_trip_s"])
        + " ms, of which the node's Detector call "
        + ", ".join(f"{t * 1e3:.1f}" for t in dlog.seconds)
        + f" ms; {len(dlog.batches)} dispatches; rects equal to the "
        f"in-process run's")
    return dict(frames=STREAM_TCP_FRAMES, dispatches=len(dlog.batches),
                seconds=pub["seconds"], send_s=pub["send_s"],
                round_trip_s=pub["round_trip_s"],
                torch_imported_by_batch=pub["torch_after"],
                dispatch_s=dlog.seconds,
                launches_per_dispatch=per_dispatch)


LOADER = r"""
import json, sys, time
import numpy as np
import torch
t0 = time.perf_counter()
from torchfcn.serve.export import load_exported
from torchfcn.ops.cuda import build
from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
from torchfcn.ops.cuda.lrn import lrn_cuda
from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda
from torchfcn.ops.cuda.stem import stem_tail_cuda
counters = {"group_rects": group_rectangles_cuda, "lrn": lrn_cuda,
            "lrn_maxpool": lrn_maxpool_cuda, "stem_tail": stem_tail_cuda}
build.library()
out = {}
frames = torch.from_numpy(np.load(sys.argv[1] + "/frames.npy")).cuda()
for name in sys.argv[2:]:
    t = time.perf_counter()
    fn = load_exported(open(f"{sys.argv[1]}/{name}.pt2", "rb").read())
    load_s = time.perf_counter() - t
    params = torch.load(f"{sys.argv[1]}/{name}.params.pt", map_location="cuda")
    for c in counters.values():
        c.launches = 0
    res = fn(params, frames)
    torch.cuda.synchronize()
    torch.save([t.cpu() for t in res], f"{sys.argv[1]}/{name}.result.pt")
    out[name] = dict(load_s=load_s, launches={k: c.launches for k, c in
                                              counters.items()})
out["zoo_imported"] = "torchfcn.models" in sys.modules
out["jax_imported"] = "jax" in sys.modules
out["seconds"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def stream_export(dets: dict, rng) -> dict:
    """Each Detector of ``dets`` (name -> Detector) exported at B = 8 with
    export_detector, the bytes loaded in a fresh process that runs them on
    the card: each result must equal its Detector's on the same frames,
    the flagship's launch the LRN kernels and groupRectangles, the
    serving preset's the stem tail and groupRectangles."""
    import tempfile

    from torchfcn.serve.export import export_detector
    frames = np.stack(stream_frames(rng, STREAM_MICRO_BATCH))
    sizes, export_s = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/frames.npy", frames)
        for name, det in dets.items():
            t = time.perf_counter()
            art = export_detector(det, STREAM_MICRO_BATCH)
            export_s[name] = time.perf_counter() - t
            sizes[name] = len(art)
            with open(f"{tmp}/{name}.pt2", "wb") as f:
                f.write(art)
            torch.save({k: v.detach() for k, v in det.forward_fn()[1].items()},
                       f"{tmp}/{name}.params.pt")
        proc = subprocess.run(
            [sys.executable, "-c", LOADER, tmp, *dets], capture_output=True,
            text=True, timeout=300, env=dict(os.environ, PYTHONPATH=os.path.
                                             dirname(os.path.abspath(
                                                 __file__))))
        if proc.returncode != 0:
            raise AssertionError(f"stream export: the loader failed:\n"
                                 f"{proc.stderr[-4000:]}")
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
        results = {name: torch.load(f"{tmp}/{name}.result.pt")
                   for name in dets}
    if loaded["zoo_imported"] or loaded["jax_imported"]:
        raise AssertionError(f"stream export: the loader imported the zoo or "
                             f"jax: {loaded}")
    required = {"googlenet_detectnet": ("lrn", "lrn_maxpool", "group_rects"),
                "googlenet_detectnet_serving": ("stem_tail", "group_rects")}
    launched = set()
    for name, det in dets.items():
        want = det(frames)
        if not want.valid.any():
            raise AssertionError(f"stream export {name}: no detections")
        for field, got in zip(want._fields, results[name]):
            if not torch.equal(got, getattr(want, field).cpu()):
                raise AssertionError(f"stream export {name}: {field} differs "
                                     f"from the Detector's")
        ran = loaded[name]["launches"]
        if any(ran[k] == 0 for k in required[name]):
            raise AssertionError(f"stream export {name}: launched {ran}")
        launched |= {k for k, v in ran.items() if v}
    if launched != {"lrn", "lrn_maxpool", "group_rects", "stem_tail"}:
        raise AssertionError(f"stream export: launched only {launched}")
    log("stream", "export: " + ", ".join(
        f"{name} {sizes[name]} bytes, export {export_s[name]:.2f} s, load "
        f"{loaded[name]['load_s']:.2f} s, launches "
        f"{loaded[name]['launches']}" for name in dets) + f"; the fresh "
        f"process took {loaded['seconds']:.2f} s without the zoo or jax; "
        f"each result equal to its Detector's")
    return {name: dict(bytes=sizes[name], export_s=export_s[name],
                       load_s=loaded[name]["load_s"],
                       launches=loaded[name]["launches"]) for name in dets}


def tiled_pointmap_graph(rng, card: str) -> dict:
    """The topology of examples/fcn_point_map.launch.json: the tiled
    fcn32s_seg node and the point-map node, float32, on the card and on
    the CPU, on one 480x640 frame with a synthetic organized cloud, object
    mask and plane coefficients.  The card's pmap must equal the CPU's but
    at a share of at most STREAM_PMAP_OFF_BY_ONE values off by one, its
    boxes and the clusters equal."""
    from torchfcn.serve.launch import launch
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "fcn_point_map.launch.json")) as f:
        spec = json.load(f)
    frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    frame[120:360, 160:480] //= 3
    h, w = frame.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    # points 2 mm apart on a plane 1 m away, an object of 120 x 120 points
    # (under the node's 25,000-point cluster limit) 20 cm in front of it
    cloud = np.stack([xs * 0.002, ys * 0.002, np.ones_like(xs)], -1)
    cloud[180:300, 260:380, 2] = 0.8
    mask = np.zeros((h, w), np.uint8)
    mask[180:300, 260:380] = 255
    remap = spec["fcn_point_map"]["remap"]
    runs = {}
    for device in ("cuda", "cpu"):
        s = json.loads(json.dumps(spec))
        s["fcn_object_detector"]["params"].update(device=device,
                                                  dtype="float32")
        graph = launch(s)
        seg = graph.nodes["fcn_object_detector"].tiled
        with torch.no_grad():
            seg.model.score_fr_6.bias[1] = STREAM_SEG_BIAS
        got = {}
        for topic in ("/fcn_object_detector/pmap", RECTS_TOPIC,
                      "/output/indices", "/output/points"):
            graph.bus.subscribe(topic, lambda m, t=topic: got.setdefault(
                t, m.data), queue_size=4)
        t0 = time.perf_counter()
        graph.bus.publish("image", frame, stamp=0.0)
        graph.spin()
        graph.bus.publish(remap["cloud"], cloud, stamp=0.0)
        graph.bus.publish(remap["mask"], mask, stamp=0.01)
        graph.bus.publish(remap["coefficients"], np.float32([0, 0, 1, -1]),
                          stamp=0.02)
        graph.spin(3)
        got["seconds"] = time.perf_counter() - t0
        if graph.nodes["fcn_point_map"].processed != 1:
            raise AssertionError(f"tiled graph on {device}: the point-map "
                                 f"node did not run")
        runs[device] = got
    on_card, cpu = runs["cuda"], runs["cpu"]
    pmap, want = on_card["/fcn_object_detector/pmap"], \
        cpu["/fcn_object_detector/pmap"]
    diff = np.abs(pmap.astype(int) - want.astype(int))
    off = float((diff > 0).mean())
    if diff.max() > 1 or off > STREAM_PMAP_OFF_BY_ONE:
        raise AssertionError(f"tiled graph: pmap differs from the cpu's by "
                             f"up to {diff.max()} at {off:.3g} of the values")
    if (pmap > 0).mean() < 0.01:
        raise AssertionError("tiled graph: the pmap holds no regions")
    rects, cpu_rects = on_card[RECTS_TOPIC], cpu[RECTS_TOPIC]
    if (rects.points, rects.labels) != (cpu_rects.points, cpu_rects.labels):
        raise AssertionError("tiled graph: boxes differ from the cpu's")
    idx, cpu_idx = on_card["/output/indices"], cpu["/output/indices"]
    if len(idx) == 0 or len(idx) != len(cpu_idx) or not all(
            np.array_equal(a, b) for a, b in zip(idx, cpu_idx)):
        raise AssertionError(f"tiled graph: clusters differ from the cpu's "
                             f"({len(idx)} against {len(cpu_idx)})")
    log("stream", f"tiled fcn32s_seg + point_map graph f32, 480x640 on "
        f"{card}: pmap card vs cpu off by one at {off:.3g} (bound "
        f"{STREAM_PMAP_OFF_BY_ONE}), {len(rects.labels)} boxes and "
        f"{len(idx)} clusters ({sum(map(len, idx))} points) equal; "
        f"{runs['cuda']['seconds']:.2f} s on the card, "
        f"{runs['cpu']['seconds']:.2f} s on the cpu")
    return dict(pmap_off_by_one=off, boxes=len(rects.labels),
                clusters=len(idx), card_s=runs["cuda"]["seconds"],
                cpu_s=runs["cpu"]["seconds"])


def stream_entry(counters) -> dict:
    """torchfcn.entry.entry(): fn(*args) on the card equals the flagship
    Detector, on its zero frames and on seeded frames with the heads
    biased."""
    from torchfcn.entry import entry
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.profile import bias_heads
    fn, (params, frames) = entry()
    det = Detector("googlenet_detectnet", max_candidates=K,
                   dtype=torch.bfloat16, rng_seed=SEED, device="cuda")
    for c in counters.values():
        c.launches = 0
    res = fn(params, frames)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    if frames.device.type != "cuda" or tuple(frames.shape) != (
            BATCH, NET, NET, 3):
        raise AssertionError(f"entry: frames {tuple(frames.shape)} on "
                             f"{frames.device}")
    assert_same_result(res, det(frames), "entry on its zero frames")
    bias_heads(det)
    x = torch.as_tensor(np.random.default_rng(SEED + 10).integers(
        0, 256, (BATCH, NET, NET, 3), dtype=np.uint8), device="cuda")
    biased = dict(params, **{k: v for k, v in det.model.state_dict().items()
                             if k.startswith(("cvg.", "bbox."))})
    res = fn(biased, x)
    assert_same_result(res, det(x), "entry on seeded frames")
    if not res.valid.any() or any(launches[k] == 0 for k in
                                  ("lrn", "lrn_maxpool", "group_rects")):
        raise AssertionError(f"entry: {int(res.valid.sum())} detections, "
                             f"launches {launches}")
    log("stream", f"entry(): fn(*args) on the card equals the Detector "
        f"({int(res.valid.sum())} detections on seeded frames); launches "
        f"{launches}")
    return dict(detections=int(res.valid.sum()), launches=launches)


def phase_stream(rng, counters, card: str) -> dict:
    """The stream serving surface on the card (the module docstring's phase
    7); returns its numbers."""
    t_phase = time.perf_counter()
    seconds = {}
    t = time.perf_counter()
    square = stream_frames(rng, STREAM_SQUARE)
    camera = stream_frames(rng, STREAM_CAMERA, (480, 640))
    flagship = ("lrn", "lrn_maxpool", "group_rects")
    node, dlog, main, calls = replay_graph(
        "googlenet_detectnet", counters, square + camera, flagship,
        ("stem_tail",), "flagship graph googlenet_detectnet bf16 K=256",
        record=True)
    serving_node, _, serving, _ = replay_graph(
        "googlenet_detectnet_serving", counters, square + camera,
        ("stem_tail", "group_rects"), ("lrn", "lrn_maxpool"),
        "serving graph googlenet_detectnet_serving e5m2")
    seconds["graphs"] = time.perf_counter() - t
    t = time.perf_counter()
    cpu = graph_against_cpu(rng)
    seconds["cpu"] = time.perf_counter() - t
    kernels = stream_kernels(calls)
    det = dlog.det
    t = time.perf_counter()
    timings = stream_timings(det, rng, card)
    seconds["timings"] = time.perf_counter() - t

    # the TCP bus against the in-process run on the same frames
    t = time.perf_counter()
    tcp_seed = SEED + 11
    from torchfcn.serve.stream import replay
    graph, local_node, local_out = stream_graph("googlenet_detectnet")
    replay(local_node, stream_frames(np.random.default_rng(tcp_seed),
                                     STREAM_TCP_FRAMES), bus=graph.bus)
    graph.spin()
    tcp = stream_tcp(counters, tcp_seed, local_out)
    seconds["tcp"] = time.perf_counter() - t
    t = time.perf_counter()
    export = stream_export({"googlenet_detectnet": det,
                            "googlenet_detectnet_serving":
                                serving_node.detector.det}, rng)
    seconds["export"] = time.perf_counter() - t
    t = time.perf_counter()
    tiled = tiled_pointmap_graph(rng, card)
    seconds["tiled"] = time.perf_counter() - t
    entry = stream_entry(counters)
    seconds["phase"] = time.perf_counter() - t_phase
    log("stream", f"phase took {seconds['phase']:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items() if k != "phase"))
    return dict(flagship=main, serving=serving, f32_against_cpu=cpu,
                against_plain=kernels, timings=timings, tcp=tcp,
                export=export, tiled_pointmap=tiled, entry=entry,
                seconds=seconds)


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
def recorded_calls(module, name: str, calls: list, limit: int = None):
    """Appends the arguments, by name with the defaults filled in, of every
    call of ``module.<name>`` inside the scope to ``calls`` (of the first
    ``limit`` calls, where given); the function itself still runs (and
    counts its launches)."""
    import inspect
    fn = getattr(module, name)
    signature = inspect.signature(fn)

    def recording(*args, **kw):
        if limit is None or len(calls) < limit:
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
    from torchfcn.serve.profile import range_device_us
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

    def profiled():
        nonlocal state
        for _ in range(PROFILED_STEPS):
            state, _ = trainer.step_fn(state, b)

    prof, rows = device_profile(profiled, f"train: {what}")
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
    (held_against_cpu)."""
    cpu = data_pipe(lib, bgs, net, batch, SEED + 10, device="cpu")
    card = data_pipe(lib, bgs, net, batch, SEED + 10)
    return held_against_cpu(cpu, card, cpu.draw(batch), "data",
                            f"{net}x{net} B={batch}")


def held_against_cpu(cpu, card, draws, phase: str, what: str) -> dict:
    """``draws`` (on the cpu) composed by the pipeline ``cpu`` and by the
    pipeline ``card`` with the caller's TF32 on; held to the DATA_* limits
    above.  A control composes the same draws on the card with the
    compositor's exact-float32 scopes made no-ops: its float image must
    differ from the cpu's by more than DATA_IMAGE_ATOL, or this check could
    not see a missing scope."""
    import torch.nn.functional as F
    want = cpu.compose(draws, checks=True)
    with caller_tf32():
        got = {k: v.cpu() for k, v in card.compose(draws.to("cuda"),
                                                   checks=True).items()}
        with compositor_scopes_removed():
            control = card.compose(draws.to("cuda"), checks=True)
            control = control["image_float"].cpu()
    for k in ("rects", "labels", "valid"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{phase}: card and cpu {k} differ at "
                                 f"{what}")
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
            f"{phase}: card against cpu at {what}: {int(seg_off.sum())} "
            f"seg pixels differ away from the mask threshold; float image "
            f"max|diff| {worst:.3g} (atol {DATA_IMAGE_ATOL:g})")
    if not control_worst > DATA_IMAGE_ATOL:
        raise AssertionError(
            f"{phase}: the control without the exact-float32 scopes passes "
            f"at {what} (max|diff| {control_worst:.3g}, atol "
            f"{DATA_IMAGE_ATOL:g}): the check cannot see a missing scope")
    h, w = want["seg"].shape[1:]
    row = dict(net=h, batch=want["seg"].shape[0],
               near_threshold_px=int(near.sum()),
               seg_differ_px=int((got["seg"] != want["seg"]).sum()),
               image_max_abs_err=worst,
               image_max_abs_err_all=float(err.max()),
               control_image_max_abs_err=control_worst,
               u8_differ_share=float((got["image"] != want["image"])
                                     .float().mean()))
    log(phase, f"card against cpu, {what}, one set of draws made on the "
        f"cpu, the caller's TF32 on: rects, labels and valid equal; "
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

    def profiled():
        for _ in range(DATA_PROFILED):
            pipe.batch(batch)

    _, rows = device_profile(profiled, f"data: compositor {net}x{net}")
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
    from torchfcn.serve.profile import range_device_us
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
    prof, rows = device_profile(lambda: steps(DATA_PROFILED_STEPS),
                                "data: Trainer steps")
    busy = sum(us for _, us, _ in rows) / 1e3 / DATA_PROFILED_STEPS
    comp = range_device_us(prof, "compositor") / 1e3 / DATA_PROFILED_STEPS
    batch = trainer.cfg.data.batch_size
    return state, dict(steps_s=DATA_TRAIN_STEPS / seconds,
                       images_s=DATA_TRAIN_STEPS * batch / seconds,
                       busy_ms_step=busy, compositor_ms_step=comp,
                       launches_per_step=launches)


def check_recorded_lrn(calls: dict, batch: int, phase: str,
                       where: str) -> dict:
    """Each LRN kernel held against its plain version on the input of its
    one recorded call (``calls``: "lrn_cuda" and "lrn_maxpool_cuda", each
    a list from recorded_calls), within check_lrn_outputs' bounds
    (phase_kernels'); the input must have ``batch`` rows and take the
    vector instance.  Returns the numbers by kernel."""
    from torchfcn.models import layers
    from torchfcn.ops.caffe_layers import lrn_across_channels
    from torchfcn.ops.cuda.lrn import vector_instance
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool
    plains = {"lrn_cuda": ("lrn", lrn_across_channels),
              "lrn_maxpool_cuda": ("lrn_maxpool", lrn_maxpool)}
    out = {}
    for fn, (name, plain) in plains.items():
        if len(calls[fn]) != 1:
            raise AssertionError(f"{phase}: {len(calls[fn])} {name} calls "
                                 f"recorded in {where}, not one")
        args = dict(calls[fn][0])
        x = args.pop("x").detach()
        if x.shape[0] != batch or not vector_instance(x.dtype, x.shape[-1],
                                                      x.data_ptr()):
            raise AssertionError(f"{phase}: {name} ran on {tuple(x.shape)} "
                                 f"{x.dtype}, not B = {batch} in the vector "
                                 f"instance")
        with torch.no_grad():
            got, want = getattr(layers, fn)(x, **args), plain(x, **args)
        torch.cuda.synchronize()
        what = f"{name} {tuple(x.shape)} {x.dtype} of {where}"
        if got.shape != want.shape:
            raise AssertionError(f"{phase}: {what}: the kernel's "
                                 f"{tuple(got.shape)}, the plain version's "
                                 f"{tuple(want.shape)}")
        err = check_lrn_outputs(got, want, x.dtype, what)
        out[name] = dict(shape=list(x.shape), dtype=str(x.dtype),
                         max_abs_err=err,
                         bit_equal_share=float((got == want).float().mean()))
        log(phase, f"{what}: the kernel against its plain version, max|err| "
            f"{err:.3g}, {100 * out[name]['bit_equal_share']:.4f} % "
            f"bit-equal")
    return out


def check_composed_lrn(trainer, state, it, batch: int) -> tuple:
    """One step of the Trainer from ``it`` with the inputs of its LRN layers
    recorded; each LRN kernel held against its plain version on the
    recorded input (check_recorded_lrn).  Returns the state and the
    numbers."""
    from torchfcn.models import layers
    calls = {"lrn_cuda": [], "lrn_maxpool_cuda": []}
    with recorded_calls(layers, "lrn_cuda", calls["lrn_cuda"]), \
            recorded_calls(layers, "lrn_maxpool_cuda",
                           calls["lrn_maxpool_cuda"]):
        state, _ = trainer.step_fn(state, trainer.put(next(it)))
    return state, check_recorded_lrn(calls, batch, "data", "a composed step")


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


# the gates phase: the accuracy gates at their capture configurations
# (torchfcn.train.gates.bench_gate_configs("bench")), through the port's
# gate entry points, on the hard benchmark's sources rendered on the host.
# The VGG16 pretrain keeps its capture shape (6 classes, 128 px, a bank of
# 8,192, B = 128, lr 1e-4) but runs GATE_PRETRAIN_STEPS of its 4,000 steps
# to fit the time limit.  Each exact reading must exceed its limit and the
# untrained model's must not; the limits sit below the lowest reading of
# the card runs (fcn32s mIoU 0.9053 and googlenet_3cls mAP 0.7949 in each,
# NVIDIA H100 80GB HBM3, 700 W; PERF.md, section 6)
GATE_PRETRAIN_STEPS = 300
GATE_SEG = "fcn32s"
GATE_DET = "googlenet_3cls"
GATE_MIOU_LIMIT, GATE_MAP_LIMIT = 0.85, 0.7
# steps of each gate's Trainer profiled for its device busy time (and the
# LRN backward's share), after as many warm-up steps
GATE_PROFILED_STEPS = 3
# the gates whose training steps are profiled: every capture-tier family
# the bank of the pretrain's profiled run: its minibatches are the capture
# shape's, only the bank they are drawn from is smaller
GATE_PRETRAIN_PROFILE_BANK = 512
GATE_PROFILED = ("fcn32s", "fcn8s", "vgg_pyramid", "googlenet_3cls",
                 "googlenet")


@contextlib.contextmanager
def counted_calls(module, name: str, counters, rows: list):
    """Each call of ``module.<name>`` inside the scope counted on its own:
    the kernels' launch counts set to 0 before it and appended to ``rows``
    after it."""
    fn = getattr(module, name)

    def counting(*args, **kw):
        for c in counters.values():
            c.launches = 0
        out = fn(*args, **kw)
        rows.append({k: c.launches for k, c in counters.items()})
        return out

    setattr(module, name, counting)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def scoring_inputs(rows: list):
    """Each call of ``gates._score_detector`` inside the scope appends to
    ``rows`` the arguments of the first call, within that scoring, of each
    wrapper that launches a model kernel: ``lrn_cuda``,
    ``lrn_maxpool_cuda`` and ``stem_tail_cuda`` (lists from
    recorded_calls, empty where the scoring's net has no such layer)."""
    from torchfcn.models import googlenet, layers
    from torchfcn.train import gates
    fn = gates._score_detector
    wrappers = ((layers, "lrn_cuda"), (layers, "lrn_maxpool_cuda"),
                (googlenet, "stem_tail_cuda"))

    def scoring(*args, **kw):
        calls = {name: [] for _, name in wrappers}
        with contextlib.ExitStack() as stack:
            for module, name in wrappers:
                stack.enter_context(recorded_calls(module, name, calls[name],
                                                   limit=1))
            out = fn(*args, **kw)
        rows.append(calls)
        return out

    gates._score_detector = scoring
    try:
        yield
    finally:
        gates._score_detector = fn


def check_recorded_stem(calls: list, batch: int, phase: str = "gates",
                        where: str = "the trained net's e5m2 scoring "
                        "chunk") -> dict:
    """The stem-tail kernel held against its plain version on the input,
    weights and halo rows of its recorded call, within check_stem_outputs'
    bounds (phase_kernels')."""
    from torchfcn.models import googlenet
    from torchfcn.ops.stem import stem_tail
    if len(calls) != 1:
        raise AssertionError(f"{phase}: {len(calls)} stem_tail calls "
                             f"recorded in {where}, not one")
    args = dict(calls[0])
    x = args["x"]
    weights = [args[k].detach() for k in ("wr", "br", "w2", "b2")]
    store = args["store_dtype"]
    halo = (args["halo_top"], args["halo_bottom"])
    if x.shape[0] != batch or store != torch.float8_e5m2:
        raise AssertionError(f"{phase}: stem_tail ran on {tuple(x.shape)} "
                             f"storing {store}, not B = {batch} in e5m2")
    with torch.no_grad():
        got = googlenet.stem_tail_cuda(x, *weights, store, *halo)
        want = stem_tail(x, *weights, store, *halo)
    what = f"stem_tail {tuple(x.shape)} halo {halo[0]}/{halo[1]} e5m2 of " \
        f"{where}"
    if got.shape != want.shape:
        raise AssertionError(f"{phase}: {what}: the kernel's "
                             f"{tuple(got.shape)}, the plain version's "
                             f"{tuple(want.shape)}")
    max_err, equal = check_stem_outputs(got, want, store, what)
    log(phase, f"{what}: the kernel against its plain version, max|err| "
        f"{max_err:.3g}, {100 * equal:.4f} % bit-equal")
    return dict(shape=list(x.shape), dtype=str(x.dtype), halo=list(halo),
                max_abs_err=max_err, bit_equal_share=equal)


def gate_cfg(cfgs: dict, family: str) -> tuple:
    """(kind, the gate's keyword arguments) of a capture-tier entry, without
    the scheduler's keys."""
    cfg = dict(cfgs[family])
    return cfg.pop("kind"), {k: v for k, v in cfg.items()
                             if k not in ("est_s", "est_s0", "seeds",
                                          "pretrain")}


def gate_step_profile(root: str, family: str, card: str) -> dict:
    """The gate's Trainer (its capture configuration, seed 0, seeded
    weights) on GATE_PROFILED_STEPS composed batches under torch.profiler,
    after as many warm-up steps: device busy per step and the LRN ops'
    plain backward's share of it."""
    from torchfcn.data.hardbench import hard_device_pipeline
    from torchfcn.serve.profile import range_device_us
    from torchfcn.train import gates
    kind, cfg = gate_cfg(gates.bench_gate_configs("bench"), family)
    g, grid = gates._gate_geometry(kind, cfg)
    model = g.get("model", "fcn32s_seg")
    trainer = gates._hard_trainer(
        model, grid, root, steps=g["steps"], batch=g["batch"], seed=0,
        with_seg=kind == "segmentation" or g["with_seg"],
        model_kwargs={"num_classes": grid.num_classes},
        lr=g.get("lr", 3e-4), device="cuda")
    pipe = hard_device_pipeline(root, grid, batch_size=g["batch"], seed=1000,
                                classes=g["classes"])
    state = trainer.init_state()
    batches = [trainer.put(pipe.batch(g["batch"]))
               for _ in range(2 * GATE_PROFILED_STEPS)]
    for b in batches[:GATE_PROFILED_STEPS]:
        state, _ = trainer.step_fn(state, b)
    torch.cuda.synchronize()

    def profiled():
        nonlocal state
        for b in batches[GATE_PROFILED_STEPS:]:
            state, _ = trainer.step_fn(state, b)

    prof, rows = device_profile(profiled, f"gates: {family} gate step")
    busy = sum(us for _, us, _ in rows) / 1e3 / GATE_PROFILED_STEPS
    bwd = sum(range_device_us(prof, f"torchfcn::{plain}_vjp")
              for plain in ("lrn_across_channels", "lrn_maxpool")
              ) / 1e3 / GATE_PROFILED_STEPS
    row = dict(model=model, batch=g["batch"], im=g["im"], busy_ms_step=busy,
               lrn_backward_ms_step=bwd, lrn_backward_share=bwd / busy)
    log("gates", f"{family} gate step, {model} B={g['batch']} "
        f"{g['im']}x{g['im']} on composed hard scenes: device busy "
        f"{busy:.3f} ms per step, the LRN ops' plain backward {bwd:.3f} ms "
        f"of it ({100 * bwd / busy:.2f} %) (torch.profiler, "
        f"{GATE_PROFILED_STEPS} steps); on {card}")
    return row


def eval_set_against_cpu(root: str, kind: str, cfg: dict) -> dict:
    """The first chunk of a gate's held-out set: build_device_eval_set's
    draws (a cpu generator seeded 99) composed on the cpu and on the card
    (held_against_cpu), and the card's composition with TF32 off equal to
    the set the gate scored, cached by build_device_eval_set."""
    from torchfcn.data.hardbench import (
        build_device_eval_set, hard_device_pipeline)
    from torchfcn.train import gates
    g, grid = gates._gate_geometry(kind, cfg)
    images, gts, segs = build_device_eval_set(
        root, grid, classes=g["classes"], n_images=g["eval_images"])
    n = min(32, g["eval_images"])
    cpu, card = (hard_device_pipeline(root, grid, batch_size=n, seed=99,
                                      classes=g["classes"], device=dev)
                 for dev in ("cpu", "cuda"))
    draws = cpu.draw(n)
    row = held_against_cpu(cpu, card, draws, "gates",
                           f"the first {n} held-out scenes of the "
                           f"{grid.im_height}x{grid.im_width} gate")
    scored = card.compose(draws.to("cuda"))
    rects = scored["rects"].cpu().numpy()
    valid = scored["valid"].cpu().numpy()
    same = np.array_equal(scored["image"].cpu().numpy(), images[:n]) and \
        np.array_equal(scored["seg"].cpu().numpy(), segs[:n]) and all(
            np.array_equal(np.concatenate([r[v][:, :2], r[v][:, :2]
                                           + r[v][:, 2:4]], 1), gt[0])
            for r, v, gt in zip(rects, valid, gts[:n]))
    if not same:
        raise AssertionError(f"gates: the card's composition of the first "
                             f"{n} held-out draws differs from the set "
                             f"build_device_eval_set cached")
    return row


def initial_params(root: str, kind: str, cfg: dict) -> dict:
    """The gate's step-0 parameters (its Trainer's seeded init, seed 0)."""
    from torchfcn.train import gates
    g, grid = gates._gate_geometry(kind, cfg)
    trainer = gates._hard_trainer(
        g.get("model", "fcn32s_seg"), grid, root, steps=g["steps"],
        batch=g["batch"], seed=0, with_seg=kind == "segmentation",
        model_kwargs={"num_classes": grid.num_classes},
        lr=g.get("lr", 3e-4), device="cuda")
    return trainer.init_state().model.state_dict()


@contextlib.contextmanager
def pretrain_clock(marks: list, prof_rows: list = None):
    """A ``log`` for pretrain_vgg16: appends (host time, line) to ``marks``.
    With ``prof_rows``, it profiles the steps after its step-1 line up to
    its last line (both read the loss back, so each follows a
    synchronisation) and appends the device rows to ``prof_rows``.  Each
    line's time is taken after the profiler's own work."""
    from torch.profiler import ProfilerActivity, profile

    from torchfcn.serve.profile import device_rows
    running = []

    def mark(line: str):
        if prof_rows is not None and line.startswith("pretrain: step "):
            if running:
                running.pop().__exit__(None, None, None)
                prof_rows.extend(device_rows(prof))
            elif line.startswith("pretrain: step 1/"):
                prof.__enter__()
                running.append(prof)
        marks.append((time.perf_counter(), line))

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        yield mark
    finally:
        for p in running:
            p.__exit__(None, None, None)


def phase_gates(counters, card: str) -> dict:
    """The accuracy gates on the card; returns their readings."""
    import tempfile

    from torchfcn import convert
    from torchfcn.convert import load_caffemodel, resolve_weights
    from torchfcn.data.hardbench import build_device_eval_set, hard_sources
    from torchfcn.models import build as build_model
    from torchfcn.serve import detector as detector_module
    from torchfcn.train import gates
    from torchfcn.train.pretrain import LOG_EVERY, pretrain_vgg16
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="torchfcn_gates_")
    cfgs = gates.bench_gate_configs("bench")
    seconds = {}

    # (a) the sources, on the host
    t = time.perf_counter()
    src = hard_sources(root)
    seconds["sources"] = time.perf_counter() - t
    log("gates", f"hard sources rendered on the host in "
        f"{seconds['sources']:.2f} s: {len(src.labels)} crops, "
        f"{len(src.backgrounds)} backgrounds of 384x512")

    # (b) the VGG16 pretrain at the capture shape, cut in steps; the steps
    # after step LOG_EVERY timed on the host.  A short run on a smaller
    # bank (the same minibatches' shapes) profiles GATE_PROFILED_STEPS
    # steps after its first
    pre = {k: v for k, v in cfgs["vgg16_pretrain"].items()
           if k not in ("kind", "est_s", "est_s0")}
    marks, prof_rows, exported = [], [], []
    for attempt in range(1, PROFILE_TRIES + 1):
        with pretrain_clock([], prof_rows) as mark:
            pretrain_vgg16(f"{root}/profiled.caffemodel", batch=128,
                           device="cuda", log=mark, **dict(
                               pre, steps=1 + GATE_PROFILED_STEPS,
                               n_bank=GATE_PRETRAIN_PROFILE_BANK))
        if prof_rows:
            break
        log("profile", f"gates: the pretrain's profiled steps recorded no "
            f"device time (profile {attempt} of {PROFILE_TRIES})")
    else:
        raise AssertionError("gates: the pretrain's profiled steps recorded "
                             f"no device time in {PROFILE_TRIES} profiles")
    pre["steps"] = GATE_PRETRAIN_STEPS
    path = f"{root}/vgg16_pretrain.caffemodel"
    t = time.perf_counter()
    with recorded_calls(convert, "export_caffemodel", exported), \
            pretrain_clock(marks) as mark:
        res = pretrain_vgg16(path, batch=128, device="cuda", log=mark, **pre)
    seconds["pretrain"] = time.perf_counter() - t
    bank_s = marks[0][0] - t
    steps_at = {int(m.split()[2].split("/")[0]): at for at, m in marks
                if m.startswith("pretrain: step ")}
    if not res["loss"] < res["loss_start"]:
        raise AssertionError(f"gates: the pretrain's loss at step "
                             f"{res['steps']} ({res['loss']}) is not below "
                             f"step 1's ({res['loss_start']})")
    classifier = exported[0]["model"]
    net = build_model("vgg_pyramid_detectnet", num_classes=5)
    resolve_weights(path, net)
    blobs = load_caffemodel(path)
    for name, conv in (("backbone/" + n, getattr(net.backbone, n))
                       for n, _ in net.backbone.named_children()):
        mine = getattr(classifier.backbone, name.split("/")[1])
        for got, want in ((conv.weight, mine.weight), (conv.bias, mine.bias)):
            if not torch.equal(got.detach().cpu(), want.detach().float().cpu()):
                raise AssertionError(f"gates: {name} of the exported "
                                     f"pretrain differs from the classifier's")
        if not np.array_equal(blobs[name][0], conv.weight.detach().numpy()):
            raise AssertionError(f"gates: {name} blob differs")
    timed = res["steps"] - LOG_EVERY
    pretrain = dict(res, bank_s=bank_s, capture_steps=cfgs["vgg16_pretrain"]
                    ["steps"], seconds=seconds["pretrain"],
                    steps_s=timed / (steps_at[res["steps"]]
                                     - steps_at[LOG_EVERY]),
                    busy_ms_step=sum(us for _, us, _ in prof_rows) / 1e3
                    / GATE_PROFILED_STEPS)
    log("gates", f"VGG16 pretrain, 6 classes at 128 px, bank of 8,192 "
        f"rendered on the host in {bank_s:.1f} s, B=128 lr 1e-4: "
        f"{res['steps']} of the capture tier's "
        f"{pretrain['capture_steps']} steps; device busy "
        f"{pretrain['busy_ms_step']:.3f} ms per step (torch.profiler, "
        f"{GATE_PROFILED_STEPS} steps), steps {LOG_EVERY + 1}-{res['steps']} "
        f"at {pretrain['steps_s']:.2f} steps/s; loss {res['loss_start']} at "
        f"step 1, {res['loss']} at step {res['steps']} (accuracy "
        f"{res['train_acc']}); exported and loaded by name into "
        f"vgg_pyramid_detectnet: its 13 backbone convs equal the "
        f"classifier's bit for bit; on {card}")

    # (c) the segmentation gate at its capture configuration
    _, seg_cfg = gate_cfg(cfgs, GATE_SEG)
    t = time.perf_counter()
    seg = gates.segmentation_gate(root=root, seeds=(0,), device="cuda",
                                  data_mode="device", **seg_cfg)
    seconds["segmentation"] = time.perf_counter() - t
    g, grid = gates._gate_geometry("segmentation", seg_cfg)
    images, _, segs = build_device_eval_set(
        root, grid, classes=g["classes"], n_images=g["eval_images"])
    seg["step0_mIoU"] = round(gates._score_segmenter(
        "fcn32s_seg", initial_params(root, "segmentation", seg_cfg), images,
        segs, grid.num_classes), 4)
    seg["steps_s"] = seg_cfg["steps"] / seg["train_s"]
    seg["eval_set_against_cpu"] = eval_set_against_cpu(root, "segmentation",
                                                       seg_cfg)
    log("gates", f"segmentation gate fcn32s_seg, 224x224, 4 classes + "
        f"background, B={seg_cfg['batch']}, {seg_cfg['steps']} steps from a "
        f"cache of {seg_cfg['n_cached']} composed batches in "
        f"{seg['train_s']} s ({seg['steps_s']:.2f} steps/s with the cache), "
        f"scored on {seg['eval_images']} held-out scenes: mIoU exact "
        f"{seg['exact']['mIoU']}, fp8 {seg['fp8']['mIoU']}, step 0 "
        f"{seg['step0_mIoU']}; limit {GATE_MIOU_LIMIT}; on {card}")
    if not seg["step0_mIoU"] < GATE_MIOU_LIMIT < seg["exact"]["mIoU"]:
        raise AssertionError(
            f"gates: mIoU {seg['step0_mIoU']} at step 0 and "
            f"{seg['exact']['mIoU']} trained do not straddle the limit "
            f"{GATE_MIOU_LIMIT}")

    # (d) the detection gate at its capture configuration, each training
    # and scoring counted on its own, the kernels' inputs of each scoring
    # recorded
    _, det_cfg = gate_cfg(cfgs, GATE_DET)
    model = det_cfg.pop("model")
    trains, scorings, nms, inputs = [], [], [], []
    t = time.perf_counter()
    with counted_calls(gates, "_train_hard", counters, trains), \
            counted_calls(gates, "_score_detector", counters, scorings), \
            scoring_inputs(inputs), \
            recorded_calls(detector_module, "vote_boxes_batched", nms):
        det = gates.detection_gate(model, root=root, seeds=(0,),
                                   device="cuda", data_mode="device",
                                   **det_cfg)
    seconds["detection"] = time.perf_counter() - t
    chunks = -(-det["eval_images"] // 32)
    steps = det_cfg["steps"]
    per_step = {k: v / steps for k, v in trains[0].items()}
    exact_l, fp8_l = scorings
    for k in ("lrn", "lrn_maxpool"):
        if per_step[k] != 1:
            raise AssertionError(f"gates: {k} launched {per_step[k]} times "
                                 f"a training step, not once")
    if exact_l["group_rects"] != chunks or fp8_l["group_rects"] != chunks:
        raise AssertionError(f"gates: groupRectangles launched "
                             f"{exact_l['group_rects']} / "
                             f"{fp8_l['group_rects']} times in {chunks} "
                             f"scoring chunks")
    if fp8_l["stem_tail"] != chunks:
        raise AssertionError(f"gates: stem_tail launched "
                             f"{fp8_l['stem_tail']} times in {chunks} fp8 "
                             f"scoring chunks")
    first = nms[0]
    rects = first["propose_boxes"].float().contiguous().clone()
    valid = first["valid"].contiguous().clone()
    if not bool(valid.any()):
        raise AssertionError("gates: the trained model's first scoring "
                             "chunk has no valid NMS candidate")
    exact_in, fp8_in = inputs
    against_plain = dict(
        group_rects=dict(shape=list(rects.shape), valid_candidates=int(
            valid.sum()), **check_group_rects(
                rects, valid, f"the trained {model}'s first scoring chunk "
                f"({int(valid.sum())} valid candidates)", timed=False,
                group_threshold=first["group_threshold"], eps=first["eps"])),
        **check_recorded_lrn(exact_in, 32, "gates",
                             f"the trained {model}'s first exact scoring "
                             f"chunk"),
        stem_tail=check_recorded_stem(fp8_in["stem_tail_cuda"], 32))
    g, grid = gates._gate_geometry("detection", det_cfg | {"model": model})
    images, gts, _ = build_device_eval_set(
        root, grid, classes=g["classes"], n_images=g["eval_images"])
    step0, _ = gates._score_detector(
        model, initial_params(root, "detection", det_cfg | {"model": model}),
        grid, images, gts, g["classes"], {"num_classes": grid.num_classes})
    det.update(step0_mAP=round(step0, 4), steps_s=steps / det["train_s"],
               launches_per_train_step=per_step,
               scoring_launches={"exact": exact_l, "fp8": fp8_l},
               scoring_chunks=chunks, against_plain=against_plain,
               eval_set_against_cpu=eval_set_against_cpu(
                   root, "detection", det_cfg | {"model": model}))
    log("gates", f"detection gate {model}, 448x448, 3 classes, B=16 lr "
        f"{det_cfg['lr']:g}, {steps} steps from a cache of "
        f"{det_cfg['n_cached']} composed batches in {det['train_s']} s "
        f"({det['steps_s']:.2f} steps/s with the cache), scored on "
        f"{det['eval_images']} held-out scenes ({det['n_gt']} boxes): mAP "
        f"exact {det['exact']['mAP']} ({det['n_det']} detections), fp8 "
        f"{det['fp8']['mAP']}, step 0 {det['step0_mAP']}; limit "
        f"{GATE_MAP_LIMIT}; launches per training step {per_step}, per "
        f"scoring of {chunks} chunks exact {exact_l}, fp8 {fp8_l}; on "
        f"{card}")
    if not det["step0_mAP"] < GATE_MAP_LIMIT < det["exact"]["mAP"]:
        raise AssertionError(
            f"gates: mAP {det['step0_mAP']} at step 0 and "
            f"{det['exact']['mAP']} trained do not straddle the limit "
            f"{GATE_MAP_LIMIT}")

    # (e) each capture-tier gate's training step, profiled
    t = time.perf_counter()
    profiles = {family: gate_step_profile(root, family, card)
                for family in GATE_PROFILED}
    seconds["profiles"] = time.perf_counter() - t
    seconds["phase"] = time.perf_counter() - t_phase
    log("gates", f"phase took {seconds['phase']:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items() if k != "phase"))
    return dict(pretrain=pretrain, segmentation=seg, detection=det,
                step_profiles=profiles,
                limits=dict(mIoU=GATE_MIOU_LIMIT, mAP=GATE_MAP_LIMIT),
                seconds=seconds)


# --- 12. mesh: the (data, space) mesh on torch.distributed --------------

MESH_TRAIN_B = 16
MESH_TIMED_STEPS = 3
# the stem tail's row-shard inputs at 448x448 (pool1: 112 rows, bands of 56
# for space = 2, of 28 for space = 4): (input rows, halo top, halo bottom)
MESH_STEM_SHARDS = ((58, 0, 2), (57, 1, 0), (31, 1, 2))
# each head of a row-sharded or batch-sharded forward against the one
# process's on the same problem size, within this share of the head's
# largest magnitude: the sound runs read 0 there, and 6.1e-3 against one
# call of the whole batch, whose convs cuDNN runs with other bf16
# algorithms; a halo zero-filled between the shards must read more (the
# control in phase_mesh)
MESH_HEAD_TOL = 1e-2
# the families row-sharded over (space=2) in the gloo processes, each a
# Detector (bf16, K = 256) on BATCH frames: (key, zoo name, frame rows x
# columns); fcn8s_bbox's 288 rows split 160 + 128 (5 + 4 pool5 rows), 432
# rows 224 + 208 (14 + 13 stride-16 rows), 448 rows 224 + 224
MESH_FAMILIES = (
    ("fcn8s_bf16", "fcn8s_bbox", (288, 288)),
    ("fcn8s_e5m2", "fcn8s_bbox_serving", (288, 288)),
    ("pyramid_bf16", "vgg_pyramid_detectnet", (NET, NET)),
    ("resnet_bf16", "resnet_fpn_detectnet", (NET, NET)),
    ("googlenet432_bf16", "googlenet_detectnet", (432, NET)),
    ("googlenet432_e5m2", "googlenet_detectnet_serving", (432, NET)),
)
# the kernels each of those runs must launch on every rank
MESH_FAMILY_KERNELS = {
    "googlenet432_bf16": ("lrn", "lrn_maxpool", "group_rects"),
    "googlenet432_e5m2": ("stem_tail", "group_rects")}
# the float32 parity() steps row-sharded over (space=2), B = 4, dropout on:
# name -> (net, grid stride, classes, preprocessing, with seg, label offset)
MESH_PARITY_FAMILIES = {
    "resnet_fpn_detectnet": (NET, 16, 4, "shift127", False, 0),
    "fcn8s_bbox": (288, 8, 11, "demean", True, 1),
}
MESH_PARITY_B = 4
# each float32 head (TF32 off) of a row-sharded family against the one
# process's, within this share of its largest magnitude: a band's convs
# sum in other orders than the frame's
MESH_F32_HEAD_TOL = 1e-5
# calls timed for the collectives' share of a row-sharded Detector call
MESH_COLLECTIVE_REPS = 10
# the row-sharded parity steps against the one process: check_mesh_step's
# routed rule, the median over weight tensors of the median entry's |diff|
# over the tensor's scale, within this.  A band's convs run on other
# shapes than the frame's, for which cuDNN picks float32 algorithms that
# sum in other orders (fcn8s_bbox read 7.7e-8, max 1.5e-3 where a max pool
# routes a near-tie apart; NVIDIA H100 80GB HBM3, 700.00 W), and the
# updated parameters are counted on the entries the gradients resolve
# (check_mesh_step's ``resolved``: on all entries conv4_3 of fcn8s_bbox
# read 0.881); each step's control (mesh_fault_step) must fail
# check_mesh_step
MESH_SPACE_GRAD_MEDIAN = 1e-6
# the wrappers whose first call in a meshed Detector call is recorded and
# held against its plain version (mesh_against_plain)
MESH_RECORDED = (("layers", "lrn_cuda"), ("layers", "lrn_maxpool_cuda"),
                 ("googlenet", "stem_tail_cuda"),
                 ("detector", "vote_boxes_batched"))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_train_step(mesh, batch, dev, timed: int = 0,
                    name: str = "googlenet_detectnet") -> dict:
    """One parity() step of ``name`` (googlenet_detectnet at 448x448, or
    one of MESH_PARITY_FAMILIES) from the seeded weights on this rank's
    share of ``batch`` (the whole batch without a mesh), dropout on: the
    loss, the gradients and the parameters after it (on the host), and
    with ``timed`` the median host-clock time of that many further steps,
    each ending in a synchronize."""
    from torchfcn.core.config import GridConfig, TrainConfig
    from torchfcn.core.dtypes import DTypePolicy
    from torchfcn.models import build as build_model
    from torchfcn.parallel.distributed import shard_batch
    from torchfcn.train.step import init_state, make_train_step
    net, stride, classes, pre, with_seg, offset = MESH_PARITY_FAMILIES.get(
        name, (NET, 16, 4, "shift127", False, 0))
    cfg = TrainConfig(grid=GridConfig(net, net, stride, classes), model=name)
    state = init_state(build_model(name, num_classes=classes), cfg,
                       rng_seed=SEED, device=dev,
                       policy=DTypePolicy.parity())
    step = make_train_step(cfg, mesh, with_seg=with_seg, preprocessing=pre,
                           label_offset=offset)
    local = {k: torch.as_tensor(v).to(dev)
             for k, v in shard_batch(batch, mesh).items()}
    state, metrics = step(state, local)
    torch.cuda.synchronize()
    out = {"loss": float(metrics["loss_total"]), "lr": cfg.learning_rate,
           "grads": {k: p.grad.cpu()
                     for k, p in state.model.named_parameters()},
           "params": {k: p.detach().cpu()
                      for k, p in state.model.named_parameters()}}
    if timed:
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            step(state, local)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["step_ms"] = statistics.median(times) * 1e3
    return out


def check_mesh_step(got: dict, want: dict, what: str, routed: bool,
                    median_limit: float = None,
                    resolved: bool = False) -> dict:
    """A meshed step against the one-process step, to the parity step's
    limits (phase 9): the losses within PARITY_LOSS_RTOL; every gradient
    within PARITY_CARD_GRAD_RTOL of its tensor's scale where both ran the
    same shapes (``routed`` False), else, as card against CPU, the median
    over weight tensors of the median entry's |diff| over the tensor's
    scale within PARITY_CPU_GRAD_MEDIAN (a batch shard's activations may
    round elsewhere, and a max pool then routes a near-tie apart); the
    updated parameters, at least PARITY_PARAM_SHARE of each tensor within
    PARITY_PARAM_LR_FRACTION * lr.  ``median_limit`` replaces
    PARITY_CPU_GRAD_MEDIAN (MESH_SPACE_GRAD_MEDIAN for row-sharded
    steps).  ``resolved``: the updated parameters' share counts only the
    entries whose gradient exceeds its difference between the two steps,
    whose signs, and so Adam's first move, the steps must agree on (a max
    pool that routes a near-tie apart moves every gradient of the conv
    below it by one position's share, and flips the sign of its smallest
    entries)."""
    median_limit = median_limit or PARITY_CPU_GRAD_MEDIAN
    if abs(got["loss"] - want["loss"]) > PARITY_LOSS_RTOL * abs(want["loss"]):
        raise AssertionError(f"{what}: loss {got['loss']} vs {want['loss']}")
    worst, medians = 0.0, []
    for k, w in want["grads"].items():
        g = got["grads"][k]
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g - w).abs().max()) / scale)
        if w.dim() > 1:
            medians.append(float((g - w).abs().median()) / scale)
    median = statistics.median(medians)
    if (not routed and worst > PARITY_CARD_GRAD_RTOL) or \
            (routed and median > median_limit):
        raise AssertionError(f"{what}: gradients max {worst:.3g}, median "
                             f"{median:.3g} of scale")
    shares, sure = [], []
    for k, w in want["params"].items():
        within = (got["params"][k] - w).abs() <= \
            PARITY_PARAM_LR_FRACTION * want["lr"]
        if resolved:
            g = want["grads"][k]
            keep = g.abs() > (got["grads"][k] - g).abs()
            within = within[keep]
            sure.append(float(keep.float().mean()))
        shares.append((float(within.float().mean()) if within.numel()
                       else 1.0, k))
    share, name = min(shares)
    if share < PARITY_PARAM_SHARE:
        g = want["grads"][name].abs()
        raise AssertionError(
            f"{what}: updated parameters {share:.4f} within the limit "
            f"({name} {tuple(g.shape)}: median |gradient| "
            f"{float(g.median()) / (float(g.max()) or 1.0):.3g} of its "
            f"largest)")
    out = {"loss": got["loss"], "grad_max_over_scale": worst,
           "grad_median_over_scale": median, "param_share": share}
    if resolved:
        out["resolved_entries_least_share"] = min(sure)
    return out


def mesh_config(name: str, hw=None):
    """The DetectorConfig of ``name`` with K = 256 at the net size ``hw``
    (rows, columns; the zoo's own without it)."""
    from torchfcn.core.config import DetectorConfig
    from torchfcn.models import get_spec
    grid = get_spec(name).grid
    if hw is not None:
        grid = dataclasses.replace(grid, im_height=hw[0], im_width=hw[1])
    return DetectorConfig(grid=grid, model=name, max_candidates=K)


def mesh_detector(name: str, mesh, dev, hw=None, dtype=torch.bfloat16):
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.profile import bias_heads
    det = Detector(name, config=mesh_config(name, hw), dtype=dtype,
                   rng_seed=SEED, device=dev, mesh=mesh)
    bias_heads(det)
    return det


def mesh_against_plain(calls: dict, batch: int, what: str) -> dict:
    """Each kernel of a meshed Detector call held against its plain version
    on the inputs of its first call there (``calls``: lists from
    recorded_calls, by wrapper): this rank's share, ``lrn_maxpool``'s and
    the stem tail's with their halo rows.  Both LRN kernels within
    check_recorded_lrn's bounds, the stem tail within check_stem_outputs',
    groupRectangles exact (phase_kernels' bounds)."""
    where = f"the {what} call"
    out = {}
    if calls["lrn_cuda"] or calls["lrn_maxpool_cuda"]:
        out.update(check_recorded_lrn(calls, batch, "mesh", where))
        args = calls["lrn_maxpool_cuda"][0]
        out["lrn_maxpool"]["halo"] = [args["halo_top"], args["halo_bottom"]]
    if calls["stem_tail_cuda"]:
        out["stem_tail"] = check_recorded_stem(calls["stem_tail_cuda"], batch,
                                               "mesh", where)
    args = calls["vote_boxes_batched"][0]
    rects = args["propose_boxes"].float().contiguous()
    valid = args["valid"].contiguous()
    out["group_rects"] = dict(
        shape=list(rects.shape), valid_candidates=int(valid.sum()),
        **check_group_rects(rects, valid, where, timed=False,
                            group_threshold=args["group_threshold"],
                            eps=args["eps"]))
    return out


def mesh_heads(det, frames, mesh) -> list:
    """The heads of ``det`` on the global ``frames`` (on a mesh, this
    rank's data shard's, gathered over the space group) on the host."""
    with torch.inference_mode():
        if mesh is None:
            heads = det._forward(torch.as_tensor(frames).cuda())
        else:
            share, banded = det._share(torch.as_tensor(frames))
            heads = det._forward(share, None, banded)
    return [h.float().cpu() for h in heads]


def mesh_detect(name: str, mesh, frames, counters: dict, hw=None) -> dict:
    """One counted run of a meshed Detector (``mesh`` None: one process)
    on the global ``frames``: its result and heads on the host, and the
    launches of each kernel in this process; on a mesh also each kernel
    against its plain version on its inputs in the counted call
    (mesh_against_plain; those launches come after the count)."""
    from torchfcn.models import googlenet, layers
    from torchfcn.serve import detector
    modules = {"layers": layers, "googlenet": googlenet,
               "detector": detector}
    det = mesh_detector(name, mesh, "cuda", hw)
    calls = {fn: [] for _, fn in MESH_RECORDED}
    for fn in counters.values():
        fn.launches = 0
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            for module, fn in MESH_RECORDED:
                stack.enter_context(recorded_calls(modules[module], fn,
                                                   calls[fn], limit=1))
        res = det(frames)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    out = {"result": [t.cpu() for t in res],
           "heads": mesh_heads(det, frames, mesh), "launches": launches,
           "det": det}
    if mesh is not None:
        out["against_plain"] = mesh_against_plain(
            calls, len(frames) // mesh.data, f"{name} {mesh.data}x"
            f"{mesh.space} mesh rank {mesh.rank}")
    return out


def wrong_halo_heads(det, frames, mesh) -> list:
    """The control of the heads' bound: the heads of a row-sharded ``det``
    with every halo row that comes from a neighbour zero-filled (the
    exchange still runs, so the ranks stay in step)."""
    import torchfcn.parallel.halo as halo
    real = halo._edges

    def zeroed(*args):
        return tuple(None if part is None else torch.zeros_like(part)
                     for part in real(*args))

    halo._edges = zeroed
    try:
        return mesh_heads(det, frames, mesh)
    finally:
        halo._edges = real


@contextlib.contextmanager
def collective_clock(spent: dict):
    """Inside the scope, the host-clock seconds (synchronised before and
    after) of every halo exchange, every all_reduce (the demean min / max,
    the pyramid's window sums, GroupNorm's statistics) and every other
    all_gather (the heads' bands, the bands' lengths) add up in ``spent``
    under "halo", "all_reduce" and "gather", with their counts under
    "<key>_n"."""
    import torch.distributed as dist

    import torchfcn.parallel.halo as halo
    real = {"halo": (halo, "_edges"), "all_reduce": (dist, "all_reduce"),
            "gather": (dist, "all_gather")}
    fns = {key: getattr(mod, attr) for key, (mod, attr) in real.items()}
    inside = []

    def clocked(key):
        def call(*args, **kw):
            if inside:           # an all_gather of a halo exchange
                return fns[key](*args, **kw)
            inside.append(key)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fns[key](*args, **kw)
            finally:
                torch.cuda.synchronize()
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
                spent[key + "_n"] = spent.get(key + "_n", 0) + 1
                inside.pop()
        return call

    for key, (mod, attr) in real.items():
        setattr(mod, attr, clocked(key))
    try:
        yield
    finally:
        for key, (mod, attr) in real.items():
            setattr(mod, attr, fns[key])


def collective_share(det, frames, reps: int = REPS) -> dict:
    """The collectives' share of a row-sharded Detector call: host clock
    around each halo exchange, all_reduce and other all_gather
    (collective_clock) against the whole call, medians of ``reps`` calls
    after WARMUP."""
    calls, shares = [], {"halo": [], "all_reduce": [], "gather": []}
    counts = {}
    for i in range(WARMUP + reps):
        spent = {}
        with collective_clock(spent):
            t0 = time.perf_counter()
            det(frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if i >= WARMUP:
            calls.append(wall)
            for key in shares:
                shares[key].append(spent.get(key, 0.0))
            counts = {k: v for k, v in spent.items() if k.endswith("_n")}
    call = statistics.median(calls)
    out = {"call_ms": call * 1e3, "reps": reps}
    for key, values in shares.items():
        out[f"{key}_ms"] = statistics.median(values) * 1e3
        out[f"{key}_share"] = statistics.median(values) / call
        out[f"{key}_calls"] = counts.get(key + "_n", 0)
    # the name the halo exchange's count had before the other collectives
    out["exchanges"] = out["halo_calls"]
    return out


# the fault each row-sharded parity step's control runs with: each band's
# GroupNorm statistics its own, or every halo row from a neighbour zeroed
MESH_FAULTS = {"resnet_fpn_detectnet": "statistics", "fcn8s_bbox": "halo"}


def mesh_fault_step(mesh, batch, name: str) -> dict:
    """The control of a row-sharded parity step: ``mesh_train_step`` with
    MESH_FAULTS' fault, which check_mesh_step must catch (the exchanges
    still run, so the ranks stay in step)."""
    import torchfcn.parallel.halo as halo
    from torchfcn.models import layers
    if MESH_FAULTS[name] == "statistics":
        module, attr = layers, "all_reduce_sum"
        fault = lambda x, group: x          # noqa: E731
    else:
        module, attr = halo, "_edges"
        real_edges = halo._edges

        def fault(*args):
            return tuple(None if part is None else torch.zeros_like(part)
                         for part in real_edges(*args))
    real = getattr(module, attr)
    setattr(module, attr, fault)
    try:
        return mesh_train_step(mesh, batch, mesh.device, name=name)
    finally:
        setattr(module, attr, real)


def mesh_rank(frames, batch, family_frames, family_batches) -> dict:
    """One of two processes that share the card over gloo: the (data=2)
    train step, then the (space=2) bf16 and e5m2 Detectors and the
    (data=2) Detector, each counted; then each of MESH_FAMILIES row-sharded
    (space=2) and counted, with its collectives' share, and the (space=2)
    parity steps of MESH_PARITY_FAMILIES, each with its control.
    Rank 0 also runs the one process's references."""
    from torchfcn.core.config import MeshConfig
    from torchfcn.core.mesh import make_mesh
    from torchfcn.ops.cuda import build
    from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
    from torchfcn.ops.cuda.lrn import lrn_cuda
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda
    from torchfcn.ops.cuda.stem import stem_tail_cuda
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    counters = {"group_rects": group_rectangles_cuda, "lrn": lrn_cuda,
                "lrn_maxpool": lrn_maxpool_cuda, "stem_tail": stem_tail_cuda}
    data, space = make_mesh(MeshConfig(2, 1)), make_mesh(MeshConfig(1, 2))
    out = {"train": mesh_train_step(data, batch, data.device,
                                    timed=MESH_TIMED_STEPS)}
    for key, name, mesh in (
            ("space_bf16", "googlenet_detectnet", space),
            ("space_e5m2", "googlenet_detectnet_serving", space),
            ("data_bf16", "googlenet_detectnet", data)):
        run = mesh_detect(name, mesh, frames, counters)
        det = run.pop("det")
        if key == "space_bf16":
            run["halo"] = collective_share(det, frames)
            run["wrong_halo_heads"] = wrong_halo_heads(det, frames, mesh)
        out[key] = run
    # the other families row-sharded: every rank's bands of each frame; in
    # float32 (TF32 off) first, the heads alone
    for key, name, hw in MESH_FAMILIES:
        if not name.endswith("_serving"):
            det = mesh_detector(name, space, "cuda", hw, torch.float32)
            out[f"f32_{key}"] = mesh_heads(det, family_frames[hw], space)
    for key, name, hw in MESH_FAMILIES:
        t0 = time.perf_counter()
        run = mesh_detect(name, space, family_frames[hw], counters, hw)
        det = run.pop("det")
        run["collectives"] = collective_share(det, family_frames[hw],
                                              MESH_COLLECTIVE_REPS)
        run["seconds"] = time.perf_counter() - t0
        out[key] = run
    for name in MESH_PARITY_FAMILIES:
        t0 = time.perf_counter()
        out[f"train_{name}"] = mesh_train_step(
            space, family_batches[name], space.device,
            timed=MESH_TIMED_STEPS, name=name)
        out[f"train_{name}"]["seconds"] = time.perf_counter() - t0
        out[f"control_{name}"] = mesh_fault_step(
            space, family_batches[name], name)
    # the one-process runs in this process (mesh=None) on the batch in two
    # calls of half the batch: the problem size of each rank's convs, by
    # which cuDNN picks its bf16 algorithms
    half = len(frames) // 2
    refs = [(name, name, frames, None) for name in
            ("googlenet_detectnet", "googlenet_detectnet_serving")]
    if space.rank == 0:
        refs += [(f"one_{key}", name, family_frames[hw], hw)
                 for key, name, hw in MESH_FAMILIES]
    for ref, name, fr, hw in refs:
        runs = [mesh_detect(name, None, part, counters, hw)
                for part in (fr[:half], fr[half:])]
        out[ref] = {key: [torch.cat(parts) for parts in
                          zip(*(r[key] for r in runs))]
                    for key in ("result", "heads")}
    if space.rank == 0:
        for key, name, hw in MESH_FAMILIES:
            if not name.endswith("_serving"):
                det = mesh_detector(name, None, "cuda", hw, torch.float32)
                out[f"one_f32_{key}"] = mesh_heads(det, family_frames[hw],
                                                   None)
    return out


def check_stem_halo(rng, dev) -> dict:
    """The stem-tail kernel on row shards (halo rows above and below read
    as data) against its plain version with the same arguments, at the
    row-sharded serving path's shard shapes, to the stem tail's bounds;
    the numbers of the first (the shape rank 0 of a space = 2 mesh runs)."""
    from torchfcn.models import build as build_model
    from torchfcn.ops.cuda.stem import stem_tail_cuda
    from torchfcn.ops.stem import stem_tail
    model = build_model("googlenet_detectnet_serving")
    model.init_weights(torch.Generator().manual_seed(SEED))
    weights = [p.detach().to(dev, torch.bfloat16) for p in (
        model.conv2_reduce.weight, model.conv2_reduce.bias,
        model.conv2.weight, model.conv2.bias)]
    store = torch.float8_e5m2
    row = None
    for rows, top, bottom in MESH_STEM_SHARDS:
        shape = (BATCH, rows, 112, 64)
        xs = (torch.from_numpy(np.abs(rng.standard_normal(shape, np.float32))
                               * 40).to(dev).to(store))
        got = stem_tail_cuda(xs, *weights, store, top, bottom)
        want = stem_tail(xs, *weights, store, top, bottom)
        if got.shape != want.shape or got.shape[1] != (rows - top - bottom) // 2:
            raise AssertionError(f"stem_tail halo {shape}: {tuple(got.shape)}")
        max_err, equal = check_stem_outputs(got, want, store,
                                            f"stem_tail halo {shape}")
        msg = (f"stem_tail {shape} halo {top}/{bottom} e5m2: max|err| "
               f"{max_err:.3g}, {equal * 100:.4f} % bit-equal")
        if row is None:
            ms = busy_ms(lambda: stem_tail_cuda(xs, *weights, store, top,
                                                bottom))
            plain_ms = busy_ms(lambda: stem_tail(xs, *weights, store, top,
                                                 bottom))
            b, h, w, _ = shape
            ho = got.shape[1]
            rows2 = 2 * ho + (1 if bottom else 0)     # conv2 rows needed
            macs = b * w * (h * 64 * 64 + rows2 * 192 * 64 * 9)
            lrn_values = b * w * (h * 64 + rows2 * 192)
            row = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                       library_ms=None, shape=list(shape),
                       halo=[top, bottom],
                       **bound(xs.numel() + got.numel()
                               + (64 * 64 + 192 * 576) * 2 + (64 + 192) * 4,
                               tensor_ops=2 * macs,
                               f32_ops=LRN_OPS * lrn_values,
                               sfu_ops=LRN_SFU_OPS * lrn_values))
            msg += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        log("mesh", msg)
    return row


def head_errors(heads: list, want: list) -> list:
    """Each head's max |diff| over the reference head's largest
    magnitude."""
    return [float((g - w).abs().max()) / float(w.abs().max())
            for g, w in zip(heads, want)]


def compare_runs(got: list, want: dict, what: str,
                 other: dict = None) -> dict:
    """The global result of a meshed Detector's ranks against the one
    process's on the same problem size (``want``: its result and heads):
    every rank the same result, equal to the one process's in every field;
    each head within MESH_HEAD_TOL of its scale.  ``other``: a one-process
    run in another process (one call of the whole batch), whose share of
    equal box entries is reported."""
    from torchfcn.serve.result import DetectionResult
    first = got[0]["result"]
    for r in got[1:]:
        for a, b in zip(r["result"], first):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: the ranks' results differ")
    res = DetectionResult(*first)
    # the data shards' heads, from each data shard's first space rank
    shards = got if what.startswith("data") else got[:1]
    heads = [torch.cat([r["heads"][i] for r in shards]) for i in range(2)]
    errs = head_errors(heads, want["heads"])
    if max(errs) > MESH_HEAD_TOL:
        raise AssertionError(f"{what}: heads differ by {errs} of scale")
    one = DetectionResult(*want["result"])
    assert_same_result(res, one, f"{what} vs the one process")
    out = {"detections": int(res.valid.sum()),
           "heads_max_over_scale": errs,
           "heads_bit_equal": all(torch.equal(g, w) for g, w in
                                  zip(heads, want["heads"])),
           "against_plain": [r["against_plain"] for r in got],
           "launches_per_rank": [r["launches"] for r in got]}
    if other is not None:
        ref = DetectionResult(*other["result"])
        out["other_process_boxes_equal_share"] = float(
            (res.boxes == ref.boxes).float().mean())
    return out


def compare_family_runs(got: list, want: dict, what: str, name: str,
                        hw) -> dict:
    """A row-sharded family's global result on its ranks against the one
    process's on the same frames (``want``, two calls of half the batch):
    every rank the same result; the heads within MESH_HEAD_TOL of their
    scale; the result equal, integers and confidences exactly, to decode +
    NMS on the CPU of the meshed heads, and to the one process's result
    where the heads are bit-equal (else the share of equal box entries is
    reported: a box near a rounding edge moves where a bf16 rounding
    moved)."""
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.result import DetectionResult
    first = got[0]["result"]
    for r in got[1:]:
        for a, b in zip(r["result"], first):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: the ranks' results differ")
    res = DetectionResult(*first)
    if int(res.valid.sum()) == 0:
        raise AssertionError(f"{what}: no detections, nothing was compared")
    heads = got[0]["heads"]
    errs = head_errors(heads, want["heads"])
    if max(errs) > MESH_HEAD_TOL:
        raise AssertionError(f"{what}: heads differ by {errs} of scale")
    cpu = Detector(name, config=mesh_config(name, hw), dtype=torch.bfloat16,
                   rng_seed=SEED, device="cpu")
    with torch.inference_mode():
        own = cpu._decode_nms(*heads, hw)
    assert_same_result(res, own, f"{what} vs decode+NMS on the cpu of its "
                       f"heads")
    one = DetectionResult(*want["result"])
    bit_equal = all(torch.equal(g, w) for g, w in zip(heads,
                                                       want["heads"]))
    if bit_equal:
        assert_same_result(res, one, f"{what} vs the one process")
    return {"detections": int(res.valid.sum()),
            "heads_max_over_scale": errs, "heads_bit_equal": bit_equal,
            "result_equal": all(torch.equal(a.cpu(), b.cpu())
                                for a, b in zip(res, one)),
            "boxes_equal_share": float((res.boxes == one.boxes).float()
                                       .mean()),
            "against_plain": [r["against_plain"] for r in got],
            "launches_per_rank": [r["launches"] for r in got],
            "collectives": got[0]["collectives"],
            "seconds": max(r["seconds"] for r in got)}


def cudnn_batch_dependence(rng, card: str) -> dict:
    """ROADMAP Queue 3 item 5: the bf16 heads of googlenet_detectnet on one
    call of BATCH frames against two calls of half of them, with cuDNN's
    default flags and under ``torch.backends.cudnn.flags(deterministic=
    True, benchmark=False)``: whether they are bit-equal, the share of
    equal entries, and the device time per batch (busy_ms) under each."""
    frames = rng.integers(0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)
    det = mesh_detector("googlenet_detectnet", None, "cuda")
    half = BATCH // 2
    out = {}
    for tag in ("default", "deterministic"):
        scope = torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=torch.backends.cudnn.allow_tf32) \
            if tag == "deterministic" else contextlib.nullcontext()
        with scope:
            whole = mesh_heads(det, frames, None)
            parts = [mesh_heads(det, p, None)
                     for p in (frames[:half], frames[half:])]
            ms = busy_ms(lambda: det(frames))
        halves = [torch.cat(p) for p in zip(*parts)]
        out[tag] = {
            "heads_bit_equal": all(torch.equal(w, h)
                                   for w, h in zip(whole, halves)),
            "equal_share": [float((w == h).float().mean())
                            for w, h in zip(whole, halves)],
            "max_over_scale": head_errors(whole, halves),
            "busy_ms_per_batch": ms}
    out["deterministic_cost"] = (out["deterministic"]["busy_ms_per_batch"]
                                 / out["default"]["busy_ms_per_batch"] - 1)
    log("mesh", f"cuDNN batch dependence, googlenet_detectnet bf16 B = "
        f"{BATCH} against 2 x {half}: default {out['default']}; "
        f"deterministic=True, benchmark=False {out['deterministic']}; "
        f"device-time cost {out['deterministic_cost'] * 100:.1f} % on "
        f"{card}")
    return out


def group_norm_cost(card: str) -> dict:
    """The port's GroupNorm (float64 statistics, one form sharded or not)
    against ``F.group_norm`` inside resnet_fpn_detectnet's bf16 forward at
    BATCH x 448x448: device time per forward (busy_ms), in turns
    (F.group_norm, the port's, the port's, F.group_norm), and the heads'
    difference, over their scale.  ``F.group_norm`` is a yardstick, used
    nowhere in the port."""
    import torch.nn.functional as F

    from torchfcn.models import layers

    def library(self, x, mesh=None):
        x = x.to(torch.float32)
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.eps)

    det = mesh_detector("resnet_fpn_detectnet", None, "cuda")
    frames = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)).cuda()
    port = layers.GroupNorm.forward
    times, heads = {"port": [], "library": []}, {}
    try:
        with torch.inference_mode():
            for tag in ("library", "port", "port", "library"):
                layers.GroupNorm.forward = port if tag == "port" else library
                times[tag].append(busy_ms(lambda: det.model(frames)))
                heads[tag] = det.model(frames)
    finally:
        layers.GroupNorm.forward = port
    out = {"port_ms": times["port"], "library_ms": times["library"],
           "cost": statistics.median(times["port"])
           / statistics.median(times["library"]) - 1,
           "heads_max_over_scale": head_errors(
               [heads["port"][k] for k in ("coverage", "bboxes")],
               [heads["library"][k] for k in ("coverage", "bboxes")])}
    log("mesh", f"GroupNorm in resnet_fpn_detectnet bf16 B = {BATCH} "
        f"{NET}x{NET}: forward {out['port_ms']} ms of device time with the "
        f"port's, {out['library_ms']} with F.group_norm "
        f"({out['cost'] * 100:+.1f} %); heads apart by "
        f"{out['heads_max_over_scale']} of scale, on {card}")
    return out


def mesh_launches(mesh: dict, name: str) -> dict:
    """A kernel's launches in each process of each mesh run: the NCCL 1 x 1
    Detector's, and per rank the gloo runs'."""
    two = mesh["gloo_two_ranks"]
    out = {"nccl_1x1": [mesh["nccl"]["detector"]["launches_per_rank"][0]
                        [name]]}
    for key in ("space_bf16", "space_e5m2", "data_bf16") + tuple(
            key for key, _, _ in MESH_FAMILIES):
        out[key] = [n[name] for n in two[key]["launches_per_rank"]]
    return out


def mesh_plain_err(mesh: dict, name: str) -> float:
    """A kernel's largest max |err| against its plain version over the
    recorded inputs of every rank of every meshed Detector run."""
    runs = [mesh["nccl"]["detector"]] + [
        mesh["gloo_two_ranks"][key]
        for key in ("space_bf16", "space_e5m2", "data_bf16") + tuple(
            key for key, _, _ in MESH_FAMILIES)]
    return max(r[name]["max_abs_err"] for run in runs
               for r in run["against_plain"] if name in r)


def phase_mesh(rng, counters, card: str) -> dict:
    """The (data, space) mesh: NCCL at world size 1, two gloo processes
    sharing the card, the stem tail on halo rows; returns the numbers."""
    from torchfcn.core.config import MeshConfig
    from torchfcn.core.mesh import make_mesh
    from torchfcn.parallel.distributed import (
        initialize_distributed, run_ranks, shutdown_distributed)
    out = {"stem_tail_halo": check_stem_halo(rng, "cuda"),
           "cudnn_batch_dependence": cudnn_batch_dependence(rng, card),
           "group_norm_cost": group_norm_cost(card)}
    frames = rng.integers(0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)
    batch = train_batch(rng, MESH_TRAIN_B, NET, 4)
    family_frames = {hw: rng.integers(0, 256, (BATCH, *hw, 3),
                                      dtype=np.uint8)
                     for hw in sorted({hw for _, _, hw in MESH_FAMILIES})}
    family_batches = {}
    for name, (net, _, classes, _, with_seg, offset) in \
            MESH_PARITY_FAMILIES.items():
        family_batches[name] = train_batch(rng, MESH_PARITY_B, net,
                                           classes - offset)
        if with_seg:
            family_batches[name]["seg"] = rng.integers(
                0, classes, (MESH_PARITY_B, net, net)).astype(np.int32)

    # the one process, mesh=None: the references
    one_step = mesh_train_step(None, batch, "cuda", timed=MESH_TIMED_STEPS)
    one_steps = {name: mesh_train_step(None, family_batches[name], "cuda",
                                       timed=MESH_TIMED_STEPS, name=name)
                 for name in MESH_PARITY_FAMILIES}
    refs = {name: mesh_detect(name, None, frames, counters)
            for name in ("googlenet_detectnet", "googlenet_detectnet_serving")}

    # NCCL at world size 1: a 1 x 1 mesh, the collectives called
    initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0,
                           device="cuda", backend="nccl")
    try:
        mesh = make_mesh(MeshConfig(1, 1))
        nccl_step = mesh_train_step(mesh, batch, mesh.device,
                                    timed=MESH_TIMED_STEPS)
        nccl = {"train": check_mesh_step(nccl_step, one_step,
                                         "NCCL 1x1 train step", False)}
        run = mesh_detect("googlenet_detectnet", mesh, frames, counters)
        run.pop("det")
        nccl["detector"] = compare_runs(
            [run], refs["googlenet_detectnet"], "NCCL 1x1 Detector")
    finally:
        shutdown_distributed()
    nccl["train"]["step_ms"] = nccl_step["step_ms"]
    nccl["train"]["one_process_step_ms"] = one_step["step_ms"]
    log("mesh", f"NCCL world 1, 1x1 mesh: train step B={MESH_TRAIN_B} "
        f"{NET}x{NET} equal to mesh=None within the parity limits "
        f"({nccl['train']}); Detector googlenet_detectnet equal "
        f"({nccl['detector']}) on {card}")

    # two processes on the one card over gloo
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, 2, frames, batch, family_frames,
                      family_batches, device="cuda", backend="gloo")
    wall = time.perf_counter() - t0
    two = {"train": check_mesh_step(ranks[0]["train"], one_step,
                                    "gloo (data=2) train step", True)}
    two["train"]["step_ms"] = ranks[0]["train"]["step_ms"]
    # against the one process in rank 0's process, the batch in two calls
    # of half its size (each rank's problem size), and reported against
    # this process's one call of the whole batch
    for key, name in (("space_bf16", "googlenet_detectnet"),
                      ("space_e5m2", "googlenet_detectnet_serving"),
                      ("data_bf16", "googlenet_detectnet")):
        what = ("data" if key.startswith("data") else "space") + f" {name}"
        two[key] = compare_runs([r[key] for r in ranks], ranks[0][name],
                                what, other=refs[name])
    two["space_bf16"]["halo"] = ranks[0]["space_bf16"]["halo"]
    # the control: zero-filled halos break the heads' bound
    wrong = head_errors(ranks[0]["space_bf16"]["wrong_halo_heads"],
                        ranks[0]["googlenet_detectnet"]["heads"])
    if max(wrong) <= MESH_HEAD_TOL:
        raise AssertionError(f"control: zero-filled halos read {wrong} of "
                             f"scale, within MESH_HEAD_TOL")
    two["space_bf16"]["wrong_halo_heads_max_over_scale"] = wrong
    two["seconds"] = wall
    # every kernel of each path launched in every rank
    for key, required in (("space_bf16", ("lrn", "lrn_maxpool", "group_rects")),
                          ("space_e5m2", ("stem_tail", "group_rects")),
                          ("data_bf16", ("lrn", "lrn_maxpool", "group_rects"))):
        for r in ranks:
            missing = [k for k in required if r[key]["launches"][k] == 0]
            if missing:
                raise AssertionError(f"{key}: a rank launched no {missing}")
    # the other families row-sharded, each against the one process
    for key, name, hw in MESH_FAMILIES:
        two[key] = compare_family_runs([r[key] for r in ranks],
                                       ranks[0][f"one_{key}"],
                                       f"space {key} {name}", name, hw)
        if f"f32_{key}" in ranks[0]:
            errs = head_errors(ranks[0][f"f32_{key}"],
                               ranks[0][f"one_f32_{key}"])
            if max(errs) > MESH_F32_HEAD_TOL:
                raise AssertionError(f"space {key} {name} float32: heads "
                                     f"differ by {errs} of scale")
            two[key]["f32_heads_max_over_scale"] = errs
        for r in ranks:
            missing = [k for k in MESH_FAMILY_KERNELS.get(
                key, ("group_rects",)) if r[key]["launches"][k] == 0]
            if missing:
                raise AssertionError(f"{key}: a rank launched no {missing}")
        r = {k: v for k, v in two[key].items()
             if k not in ("collectives", "against_plain")}
        shares = ", ".join(
            f"{part} {c[part + '_ms']:.3f} ms ({c[part + '_share'] * 100:.1f}"
            f" %, {c[part + '_calls']} calls)"
            for c in [two[key]["collectives"]]
            for part in ("halo", "all_reduce", "gather"))
        log("mesh", f"{key} ({name}, {BATCH} x {hw[0]}x{hw[1]}, space=2): "
            f"{r}; collectives of a {two[key]['collectives']['call_ms']:.3f}"
            f" ms call: {shares} on {card}")
    # their float32 parity steps, each with a control that must fail the
    # same check
    for name in MESH_PARITY_FAMILIES:
        got, want = ranks[0][f"train_{name}"], one_steps[name]
        what = f"gloo (space=2) {name} train step"
        try:
            check_mesh_step(ranks[0][f"control_{name}"], want,
                            f"control of the {what}", True,
                            MESH_SPACE_GRAD_MEDIAN, resolved=True)
        except AssertionError as e:
            control = str(e)
        else:
            raise AssertionError(f"control of the {what} ({MESH_FAULTS[name]}"
                                 f" fault) passed its check")
        two[f"train_{name}"] = dict(
            check_mesh_step(got, want, what, True, MESH_SPACE_GRAD_MEDIAN,
                            resolved=True),
            step_ms=got["step_ms"], one_process_step_ms=want["step_ms"],
            seconds=got["seconds"], control=control)
        log("mesh", f"(space=2) parity step {name} B={MESH_PARITY_B}: "
            f"{two[f'train_{name}']} on {card}")
    out.update(nccl=nccl, gloo_two_ranks=two,
               one_process_launches={k: v["launches"]
                                     for k, v in refs.items()})
    halo = two["space_bf16"]["halo"]
    log("mesh", f"gloo, 2 processes on one card, {wall:.1f} s: (data=2) "
        f"train step {two['train']}")
    for key in ("space_bf16", "space_e5m2", "data_bf16"):
        r = {k: v for k, v in two[key].items()
             if k not in ("halo", "against_plain")}
        log("mesh", f"{key}: equal to the one process, each kernel equal "
            f"to its plain version on each rank's inputs; {r}")
    log("mesh", f"halo exchange: {halo['exchanges']} exchanges, "
        f"{halo['halo_ms']:.3f} ms of a {halo['call_ms']:.3f} ms "
        f"row-sharded Detector call ({halo['halo_share'] * 100:.1f} %); "
        f"train step: one process {one_step['step_ms']:.3f} ms, NCCL 1x1 "
        f"mesh {nccl_step['step_ms']:.3f} ms, 2 gloo ranks "
        f"{two['train']['step_ms']:.3f} ms (host clock, median of "
        f"{MESH_TIMED_STEPS}) on {card}")
    return out


# --- 13. records: the record and VOC data path, the voc_fixture gate ---

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
VOC_FIXTURE = os.path.join(REPO_ROOT, "tests", "fixtures", "voc_mini")
# sha256 over the 144 fixture JPEGs' pixels as cv.imdecode(IMREAD_COLOR)
# gives them (in file-name order), and over cv.imencode(".jpg", pixels,
# quality 95) of each: printed by tests/test_torch_jpeg.py from cv2
FIXTURE_DECODE_SHA256 = \
    "01f3a1e3e21a5a8322e8086fc65c18aa1a9a85f30b461a4e7d1b24ed7a9e3764"
FIXTURE_ENCODE_SHA256 = \
    "f04a407e06e30dc9cde0342011271e2321c0e449292d87f6b08caf65cf738738"
VOC_TRAIN, VOC_VAL, VOC_VAL_BOXES = 48, 96, 168
RECORDS_TRAIN_STEPS = 20
# the voc_fixture gate's held-out mAP after its capture configuration must
# pass this, the untrained net's must not: below the card's readings
# (0.3838 in two runs, the untrained net 0.0; NVIDIA H100 80GB HBM3,
# 700.00 W)
VOC_MAP_LIMIT = 0.25
# the gate's steps in this script: its capture configuration's
VOC_GATE_STEPS = 3000


def fixture_codec(card: str) -> dict:
    """The fixture's 144 JPEGs decoded by the port, held against cv2's
    digest; the pixels re-encoded at quality 95, held against cv2's digest
    of its encodes, and decoded again; seconds per image of each."""
    import glob
    import hashlib

    from torchfcn.data import jpeg
    files = sorted(glob.glob(os.path.join(VOC_FIXTURE, "JPEGImages",
                                          "*.jpg")))
    if len(files) != VOC_TRAIN + VOC_VAL:
        raise AssertionError(f"records: {len(files)} fixture JPEGs, not "
                             f"{VOC_TRAIN + VOC_VAL}")
    raw = [open(f, "rb").read() for f in files]
    jpeg.decode(raw[0])                    # the entropy coder's build
    t = time.perf_counter()
    images = [jpeg.decode(b, f) for b, f in zip(raw, files)]
    decode_s = (time.perf_counter() - t) / len(files)
    t = time.perf_counter()
    encoded = [jpeg.encode(img, 95) for img in images]
    encode_s = (time.perf_counter() - t) / len(files)
    again = [jpeg.decode(b) for b in encoded]
    got = hashlib.sha256(b"".join(img.tobytes() for img in images))
    enc = hashlib.sha256(b"".join(encoded))
    if got.hexdigest() != FIXTURE_DECODE_SHA256:
        raise AssertionError("records: the decoded fixture's digest "
                             f"{got.hexdigest()} is not cv2's")
    if enc.hexdigest() != FIXTURE_ENCODE_SHA256:
        raise AssertionError("records: the re-encoded fixture's digest "
                             f"{enc.hexdigest()} is not cv2's")
    drift = max(float(np.abs(a.astype(np.int16) - b).mean())
                for a, b in zip(images, again))
    if drift > 2.0:
        raise AssertionError(f"records: a q95 round trip moves pixels by "
                             f"{drift:.3f} on average")
    log("records", f"{len(files)} fixture JPEGs of 320x240 decoded bit-equal "
        f"to cv2 (digest), re-encoded byte-equal to cv2 at q95 (digest), "
        f"decoded again within {drift:.3f} on average: decode "
        f"{1e3 * decode_s:.2f} ms, encode {1e3 * encode_s:.2f} ms per image "
        f"on the host; on {card}")
    return dict(images=len(files), decode_ms=1e3 * decode_s,
                encode_ms=1e3 * encode_s, round_trip_mean_abs=drift)


def cli_json(argv: list) -> list:
    """``torchfcn.cli.main(argv)`` in this process; its stdout's lines."""
    import io

    from torchfcn import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().splitlines()


def records_chain(counters, card: str) -> dict:
    """The CLI chain voc -> records (train and val splits) -> records
    --inspect -> train --records on the card with --val-records -> eval
    --format voc, groupRectangles counted in training and in eval."""
    import tempfile
    work = tempfile.mkdtemp(prefix="torchfcn_records_")
    man, rec, val = (os.path.join(work, d) for d in ("man", "rec/ds",
                                                      "rec/val"))
    t = time.perf_counter()
    cli_json(["voc", VOC_FIXTURE, "--out", man, "--classes", "ball", "crate",
              "cone"])
    lines = {split: open(os.path.join(man, f"{split}.txt")).read()
             .splitlines() for split in ("train", "val")}
    if (len(lines["train"]), len(lines["val"])) != (VOC_TRAIN, VOC_VAL):
        raise AssertionError(f"records: the VOC converter wrote "
                             f"{len(lines['train'])} / {len(lines['val'])} "
                             f"samples, not {VOC_TRAIN} / {VOC_VAL}")
    for prefix, split in ((rec, "train"), (val, "val")):
        cli_json(["records", "--manifest", os.path.join(man, f"{split}.txt"),
                  "--format", "voc", "--out", prefix])
    inspect = [json.loads(l) for l in cli_json(
        ["records", "--inspect", "--limit", "2", "--out", rec])]
    if inspect[-1]["records"] != VOC_TRAIN or not all(
            l["labels"] and l["image"] == [240, 320, 3]
            for l in inspect[:-1]):
        raise AssertionError(f"records: --inspect read {inspect}")
    convert_s = time.perf_counter() - t
    snap = os.path.join(work, "snap")
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    trained = json.loads(cli_json(
        ["train", "--recipe", "bounding_box", "--records", rec,
         "--max-iter", str(RECORDS_TRAIN_STEPS), "--snapshot-dir", snap,
         "--eval-every", str(RECORDS_TRAIN_STEPS), "--val-records", val,
         "--device", "cuda"])[-1])
    train_s = time.perf_counter() - t
    train_launches = {k: c.launches for k, c in counters.items()}
    if trained["trained_to"] != RECORDS_TRAIN_STEPS or trained["best"] is None:
        raise AssertionError(f"records: train --records gave {trained}")
    # one validation of 64 held-out records in chunks of 32
    if train_launches["group_rects"] != 2:
        raise AssertionError(f"records: groupRectangles launched "
                             f"{train_launches['group_rects']} times in one "
                             f"validation of 2 chunks")
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    res = json.loads(cli_json(
        ["eval", "--manifest", os.path.join(man, "val.txt"), "--format",
         "voc", "--model", "vgg_detectnet_train", "--weights", snap,
         "--device", "cuda"])[-1])
    eval_s = time.perf_counter() - t
    eval_launches = {k: c.launches for k, c in counters.items()}
    if res["images"] != VOC_VAL or set(res["ap"]) != {"0", "1", "2"} or \
            not 0.0 <= res["mAP"] <= 1.0:
        raise AssertionError(f"records: eval gave {res}")
    if eval_launches["group_rects"] != VOC_VAL:
        raise AssertionError(f"records: groupRectangles launched "
                             f"{eval_launches['group_rects']} times over "
                             f"{VOC_VAL} images, not once an image")
    log("records", f"CLI chain: voc -> records ({VOC_TRAIN} + {VOC_VAL}) -> "
        f"--inspect in {convert_s:.2f} s; train --records bounding_box "
        f"B=32 224x224 {RECORDS_TRAIN_STEPS} steps with --val-records in "
        f"{train_s:.2f} s (val mAP {trained['best']['score']}); eval --format "
        f"voc of {res['images']} images in {eval_s:.2f} s: mAP {res['mAP']}; "
        f"launches in training {train_launches}, in eval {eval_launches}; "
        f"on {card}")
    return dict(convert_s=convert_s, train_s=train_s, eval_s=eval_s,
                val_mAP=trained["best"]["score"], eval=res,
                train_launches=train_launches, eval_launches=eval_launches)


def voc_step_profile(work: str) -> float:
    """The VOC gate's Trainer (seed 0) on GATE_PROFILED_STEPS record batches
    under torch.profiler, after as many warm-up steps: device busy ms per
    step."""
    from torchfcn.data.pipeline import RecordTrainPipeline
    from torchfcn.train import gates
    trainer = gates.voc_trainer(work, steps=VOC_GATE_STEPS, batch=16,
                                lr=1e-4, seed=0, device="cuda")
    pipe = iter(RecordTrainPipeline(os.path.join(work, "rec", "ds"),
                                    gates.VOC_GRID, batch_size=16, seed=1000))
    state = trainer.init_state()
    batches = [trainer.put(next(pipe))
               for _ in range(2 * GATE_PROFILED_STEPS)]
    for b in batches[:GATE_PROFILED_STEPS]:
        state, _ = trainer.step_fn(state, b)
    torch.cuda.synchronize()

    def profiled():
        nonlocal state
        for b in batches[GATE_PROFILED_STEPS:]:
            state, _ = trainer.step_fn(state, b)

    _, rows = device_profile(profiled, "records: voc_fixture gate step")
    return sum(us for _, us, _ in rows) / 1e3 / GATE_PROFILED_STEPS


def phase_records(counters, card: str) -> dict:
    """The record and VOC data path on the card; returns its readings."""
    import tempfile

    from torchfcn.serve import detector as detector_module
    from torchfcn.train import gates
    t_phase = time.perf_counter()
    codec = fixture_codec(card)
    chain = records_chain(counters, card)

    # the voc_fixture gate at its capture configuration, each scoring
    # counted, the NMS inputs of the first scoring chunk recorded
    work = tempfile.mkdtemp(prefix="torchfcn_vocgate_")
    scorings, nms = [], []
    t = time.perf_counter()
    with counted_calls(gates, "score_voc", counters, scorings), \
            recorded_calls(detector_module, "vote_boxes_batched", nms,
                           limit=1):
        res = gates.voc_fixture_gate(steps=VOC_GATE_STEPS, work_root=work,
                                     device="cuda")
    wall = time.perf_counter() - t
    if (res["val_images"], res["n_gt"]) != (VOC_VAL, VOC_VAL_BOXES):
        raise AssertionError(f"records: the gate scored {res['val_images']} "
                             f"images with {res['n_gt']} boxes, not "
                             f"{VOC_VAL} with {VOC_VAL_BOXES}")
    chunks = -(-VOC_VAL // 8)
    if scorings[0]["group_rects"] != chunks:
        raise AssertionError(f"records: groupRectangles launched "
                             f"{scorings[0]['group_rects']} times in the "
                             f"gate's {chunks} scoring chunks")
    first = nms[0]
    rects = first["propose_boxes"].float().contiguous().clone()
    valid = first["valid"].contiguous().clone()
    against_plain = dict(shape=list(rects.shape), valid_candidates=int(
        valid.sum()), **check_group_rects(
            rects, valid, f"the trained voc_fixture net's first scoring chunk "
            f"({int(valid.sum())} valid candidates)",
            group_threshold=first["group_threshold"], eps=first["eps"]))
    # the control: the gate's net untrained (its Trainer's seeded init),
    # scored on the same held-out set
    from torchfcn.train.validate import val_set_from_voc
    trainer = gates.voc_trainer(work, steps=VOC_GATE_STEPS, batch=16,
                                lr=1e-4, seed=0, device="cuda")
    vi, vg = val_set_from_voc(os.path.join(work, "man", "val.txt"),
                              gates.VOC_EVAL_HW)
    control = gates.score_voc(trainer, trainer.init_state(), vi, vg)
    busy = voc_step_profile(work)
    step_ms = 1e3 * res["train_s"] / VOC_GATE_STEPS
    res.update(steps=VOC_GATE_STEPS, wall_s=wall, step0_mAP=control["mAP"],
               step0_n_det=control["n_det"], scoring_launches=scorings[0],
               scoring_chunks=chunks, against_plain=against_plain,
               steps_s=VOC_GATE_STEPS / res["train_s"], step_ms=step_ms,
               busy_ms_step=busy, idle_share=1 - busy / step_ms)
    log("records", f"voc_fixture gate, vgg_detectnet_train 224x224 B=16, "
        f"{VOC_GATE_STEPS} steps from a cache of 10 record batches, Adam lr "
        f"1e-4: mAP {res['mAP']} ({res['n_det']} detections) on "
        f"{res['val_images']} val images at 448x448 ({res['n_gt']} boxes), "
        f"step 0 {control['mAP']} ({control['n_det']} detections); limit "
        f"{VOC_MAP_LIMIT}; convert {res['convert_s']} s, compose "
        f"{res['compose_s']} s, train {res['train_s']} s "
        f"({res['steps_s']:.2f} steps/s, {step_ms:.2f} ms a step, of which "
        f"the device is busy {busy:.3f} ms by torch.profiler over "
        f"{GATE_PROFILED_STEPS} steps: idle {100 * res['idle_share']:.1f} "
        f"%), eval {res['eval_s']} s; "
        f"groupRectangles {scorings[0]['group_rects']} launches in "
        f"{chunks} scoring chunks; on {card}")
    if not control["mAP"] < VOC_MAP_LIMIT < res["mAP"]:
        raise AssertionError(
            f"records: mAP {control['mAP']} at step 0 and {res['mAP']} "
            f"trained do not straddle the limit {VOC_MAP_LIMIT}")
    seconds = time.perf_counter() - t_phase
    log("records", f"phase took {seconds:.1f} s")
    return dict(codec=codec, chain=chain, gate=res,
                limits=dict(mAP=VOC_MAP_LIMIT), seconds=seconds)


# --- 14. tools: the label tools, CNN codes on the card ---

# the extractor's float32 codes on the card against the CPU's, and the
# cosine of its bf16 codes with the float32 ones.  On an NVIDIA H100 80GB
# HBM3 at 700.00 W this phase reads 1.04e-7 in float32 and 1.08e-4 with
# TF32 on: a bound of 1e-4 would barely tell the two apart, so the bound
# sits a decade from each reading
TOOLS_CODE_ATOL = 1e-5
# on the same card the bf16 codes read a least cosine of 0.99999 with the
# float32 ones, the controls 0.9969 (crop 113's pixel rows shuffled) and
# 0.968 (codes of other crops): the bound sits between them
TOOLS_MIN_COSINE = 0.9995
# the roi_classifier's probabilities, card against CPU (both float32): the
# fitted head turns a code's |d| of 1e-7 into about 2e-6 of probability
TOOLS_PROB_ATOL = 1e-4
TOOLS_FRAMES, TOOLS_HW = 32, (480, 640)
# the sequence's frames whose object is hidden behind noise
TOOLS_OCCLUDED = (11, 23)
# the refine and rank walks' Bhattacharyya thresholds, chosen on the CPU
# (float32, seeded weights) in gaps of the distances each walk compares
# (refine: the object's crops against the occluded ones; rank: over the
# 168 fixture crops), gaps far wider than float32 rounding on the card
TOOLS_REFINE_THRESHOLD = 0.03
TOOLS_RANK_THRESHOLD = 0.045
TOOLS_GRAPH_FRAMES = 8
TOOLS_BATCHES = (1, 16, VOC_VAL_BOXES)


def fixture_crops() -> tuple:
    """The fixture's val images (port imread) and their ground-truth boxes:
    (paths, images, [(image index, (x, y, w, h), label)], crops)."""
    from torchfcn.data.imageio import imread
    from torchfcn.data.voc import parse_annotation
    names = ("ball", "crate", "cone")
    with open(os.path.join(VOC_FIXTURE, "ImageSets", "Main", "val.txt")) as f:
        ids = [ln.split()[0] for ln in f if ln.strip()]
    paths = [os.path.join(VOC_FIXTURE, "JPEGImages", i + ".jpg") for i in ids]
    images = [imread(p) for p in paths]
    boxes = [(k, rect, names.index(name)) for k, i in enumerate(ids)
             for name, rect in parse_annotation(
                 os.path.join(VOC_FIXTURE, "Annotations", i + ".xml"))]
    crops = [images[k][y:y + h, x:x + w] for k, (x, y, w, h), _ in boxes]
    if (len(images), len(crops)) != (VOC_VAL, VOC_VAL_BOXES):
        raise AssertionError(f"tools: {len(images)} val images with "
                             f"{len(crops)} boxes, not {VOC_VAL} with "
                             f"{VOC_VAL_BOXES}")
    return paths, images, boxes, crops


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The cosine of each row of ``a`` with the same row of ``b``."""
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def tools_codes(crops: list, dev: str) -> tuple:
    """Check (a): the extractor's float32 codes on ``dev`` (TF32 off)
    against the CPU's on the same resized batch, its bf16 codes' cosine
    with the float32 ones, and the controls that must miss each bound:
    float32 with TF32 on, the bf16 codes' rows permuted (each held against
    another crop's float32 code), and the largest crop's bf16 code with its
    pixel rows shuffled.  Returns (the readings, the float32 codes on the
    CPU)."""
    from torchfcn.tools.features import CnnCodeExtractor
    f32 = CnnCodeExtractor(dtype=torch.float32, device=dev)
    bf16 = CnnCodeExtractor(dtype=torch.bfloat16, device=dev)
    cpu = CnnCodeExtractor(dtype=torch.float32, device="cpu")
    batch = f32.batch(crops)
    with cpu.policy.precision():
        want = cpu.codes(batch.cpu()).numpy()
    with f32.policy.precision():
        got = f32.codes(batch).cpu().numpy()
    err = float(np.abs(got - want).max())
    with caller_tf32() if dev != "cpu" else contextlib.nullcontext():
        tf32 = f32.codes(batch).cpu().numpy()
    tf32_err = float(np.abs(tf32 - want).max())
    half = bf16.codes(batch).cpu().numpy()
    cos = float(cosines(half, got).min())
    perm = np.random.default_rng(SEED).permutation(len(crops))
    cos_control = float(cosines(half[perm], got).min())
    big = int(np.argmax([c.shape[0] * c.shape[1] for c in crops]))
    rows = crops[big][np.random.default_rng(SEED).permutation(
        len(crops[big]))]
    cos_rows = float(cosines(bf16([rows]), got[big:big + 1])[0])
    res = dict(crops=len(crops), f32_max_abs_err=err,
               tf32_max_abs_err=tf32_err, bf16_min_cosine=cos,
               permuted_min_cosine=cos_control,
               pixel_rows_shuffled_cosine=cos_rows, shuffled_crop=big,
               limits=dict(atol=TOOLS_CODE_ATOL, min_cosine=TOOLS_MIN_COSINE))
    log("tools", f"codes of {len(crops)} fixture crops at 224x224: float32 "
        f"on {dev} vs the CPU max |d| {err:.3g} (limit {TOOLS_CODE_ATOL}), "
        f"with TF32 on {tf32_err:.3g}; bf16 vs float32 min cosine {cos:.6f} "
        f"(limit {TOOLS_MIN_COSINE}), its rows permuted {cos_control:.6f}; "
        f"crop {big} with its pixel rows shuffled {cos_rows:.6f}")
    if not err <= TOOLS_CODE_ATOL < tf32_err:
        raise AssertionError(f"tools: float32 codes {err} and the TF32 "
                             f"control {tf32_err} do not straddle "
                             f"{TOOLS_CODE_ATOL}")
    if not max(cos_control, cos_rows) < TOOLS_MIN_COSINE <= cos:
        raise AssertionError(f"tools: bf16 cosines {cos} and the controls "
                             f"{cos_control} (permuted), {cos_rows} (rows "
                             f"shuffled) do not straddle {TOOLS_MIN_COSINE}")
    return res, want


def tool_sequence(work: str, seed: int) -> tuple:
    """TOOLS_FRAMES frames of TOOLS_HW: noise with a textured 96 x 72 object
    moving 3 to 8 px a frame (hidden behind noise in TOOLS_OCCLUDED), as
    PNGs, and a manifest of rough boxes (the true box moved by up to 4 px):
    (manifest path, frames, true boxes)."""
    from torchfcn.data.imageio import imwrite
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:96, 0:72]
    patch = np.stack([30 + gx * 3, 220 - gy * 2, 120 + ((gx + gy) % 7) * 18],
                     axis=-1).clip(0, 255).astype(np.uint8)
    (h, w), x, y = TOOLS_HW, 100, 80
    step = rng.integers(3, 9, 2) * rng.choice([-1, 1], 2)
    frames, truth, lines = [], [], []
    for i in range(TOOLS_FRAMES):
        img = rng.integers(0, 60, TOOLS_HW + (3,)).astype(np.uint8)
        img[y:y + 96, x:x + 72] = patch if i not in TOOLS_OCCLUDED else \
            rng.integers(0, 256, (96, 72, 3)).astype(np.uint8)
        path = os.path.join(work, f"f{i:02d}.png")
        imwrite(path, img)
        frames.append(img)
        truth.append((x, y, 72, 96))
        jx, jy = rng.integers(-4, 5, 2)
        lines.append(f"{path} {x + jx} {y + jy} 72 96 1")
        step = np.where((np.array([x, y]) + step < 0)
                        | (np.array([x, y]) + step + [72, 96] > [w, h]),
                        -step, step)
        x, y = int(x + step[0]), int(y + step[1])
        step = rng.integers(3, 9, 2) * np.sign(step)
    man = os.path.join(work, "train.txt")
    with open(man, "w") as f:
        f.write("\n".join(lines) + "\n")
    return man, frames, truth


def cli_walk(cmd: str, man: str, dev: str, extra: list) -> tuple:
    """``cli <cmd>`` over ``man`` on ``dev`` in float32 with seeded weights:
    (its JSON line, the lines it wrote, seconds)."""
    out = f"{man[:-4]}_{cmd}_{dev}.txt"
    t = time.perf_counter()
    res = json.loads(cli_json([cmd, "--manifest", man, "--out", out,
                               "--dtype", "float32", "--device", dev]
                              + extra)[-1])
    return res, open(out).read().splitlines(), time.perf_counter() - t


def tools_refine(work: str, dev: str) -> dict:
    """Check (b): ``cli refine`` over the sequence on ``dev`` and on the
    CPU, the refined manifests equal line for line; ncc_track timed on the
    host over the sequence's frame pairs."""
    from torchfcn.tools.boundary_refinement import ncc_track
    man, frames, truth = tool_sequence(work, SEED)
    extra = ["--threshold", str(TOOLS_REFINE_THRESHOLD)]
    got, lines, wall = cli_walk("refine", man, dev, extra)
    want, want_lines, cpu_wall = cli_walk("refine", man, "cpu", extra)
    if got["refined"] != TOOLS_FRAMES or lines != want_lines:
        unlike = sum(a != b for a, b in zip(lines, want_lines))
        raise AssertionError(f"tools: refine on {dev} wrote {got} "
                             f"({unlike} lines unlike the CPU's)")
    moved = sum(l != m for l, m in zip(lines, open(man).read().splitlines()))
    t = time.perf_counter()
    tracked = [ncc_track(frames[i], truth[i], frames[i + 1])
               for i in range(TOOLS_FRAMES - 1)]
    ncc_ms = 1e3 * (time.perf_counter() - t) / (TOOLS_FRAMES - 1)
    found = sum(abs(r[0] - truth[i + 1][0]) <= 1
                and abs(r[1] - truth[i + 1][1]) <= 1
                for i, r in enumerate(tracked)
                if i + 1 not in TOOLS_OCCLUDED)
    log("tools", f"cli refine of {TOOLS_FRAMES} frames of {TOOLS_HW[1]}x"
        f"{TOOLS_HW[0]} in float32 (threshold {TOOLS_REFINE_THRESHOLD}): "
        f"equal to the CPU's line for line, {moved} boxes moved by the "
        f"tracker; {wall:.2f} s on {dev}, {cpu_wall:.2f} s on the CPU; "
        f"ncc_track {ncc_ms:.2f} ms a frame pair on the host, the true box "
        f"found in {found} of {TOOLS_FRAMES - 1 - len(TOOLS_OCCLUDED)} "
        f"unoccluded pairs")
    return dict(frames=TOOLS_FRAMES, moved=moved, wall_s=wall,
                cpu_wall_s=cpu_wall, ncc_track_ms=ncc_ms, ncc_found=found)


def tools_rank(work: str, paths: list, boxes: list, dev: str) -> dict:
    """Check (c): ``cli rank`` over a manifest of the fixture's boxes (one
    line each) on ``dev`` and on the CPU, the kept lines equal."""
    man = os.path.join(work, "crops.txt")
    with open(man, "w") as f:
        for k, (x, y, w, h), label in boxes:
            f.write(f"{paths[k]} {x} {y} {w} {h} {label + 1}\n")
    extra = ["--threshold", str(TOOLS_RANK_THRESHOLD)]
    got, lines, wall = cli_walk("rank", man, dev, extra)
    want, want_lines, cpu_wall = cli_walk("rank", man, "cpu", extra)
    if lines != want_lines or got["total"] != VOC_VAL_BOXES:
        raise AssertionError(f"tools: rank on {dev} kept {got['kept']} "
                             f"lines, the CPU {want['kept']}, not the same")
    log("tools", f"cli rank of {VOC_VAL_BOXES} fixture crops in float32 "
        f"(threshold {TOOLS_RANK_THRESHOLD}): kept {got['kept']}, equal to "
        f"the CPU's; {wall:.2f} s on {dev}, {cpu_wall:.2f} s on the CPU")
    return dict(kept=got["kept"], total=got["total"], wall_s=wall,
                cpu_wall_s=cpu_wall)


def tools_graph(work: str, images: list, boxes: list, codes: np.ndarray,
                dev: str) -> dict:
    """One launch graph of a capture, a boundary_refinement and a
    roi_classifier node (float32 codes on ``dev``, its head fitted to
    ``codes`` and the fixture's 3 labels) over TOOLS_GRAPH_FRAMES fixture
    frames, each frame's boxes published as a RectsMsg and its first box
    on /object_rect."""
    from torchfcn.serve.launch import launch
    from torchfcn.serve.stream import RectsMsg
    from torchfcn.tools.features import CnnCodeExtractor
    from torchfcn.tools.roi_classifier import ROIClassifier
    clf = ROIClassifier(3, extractor=CnnCodeExtractor(
        dtype=torch.float32, device=dev))
    clf.fit_head(codes, np.array([label for *_, label in boxes]), 3)
    cap = os.path.join(work, f"capture_{dev}")
    image = "/camera/rgb/image_rect_color"
    graph = launch({
        "capture": {"type": "capture", "params": {"out_dir": cap}},
        "boundary_refinement": {"type": "boundary_refinement"},
        "roi_classifier": {"type": "roi_classifier",
                           "params": {"classifier": clf},
                           "remap": {"image": image}},
    })
    refined, kept = [], []
    graph.bus.subscribe("/boundary_refinement/rect", refined.append)
    graph.bus.subscribe("/rcnn_detector/rects", kept.append)
    t = time.perf_counter()
    for k in range(TOOLS_GRAPH_FRAMES):
        rects = [rect for i, rect, _ in boxes if i == k]
        graph.bus.publish(image, images[k], stamp=float(k))
        graph.bus.publish(RECTS_TOPIC, RectsMsg(
            [p for x, y, w, h in rects for p in ((x, y), (x + w, y + h))],
            [0] * len(rects), [1.0] * len(rects)), stamp=float(k))
        graph.bus.publish("/object_rect", list(rects[0]), stamp=float(k))
        graph.spin()
    graph.spin()
    wall = time.perf_counter() - t
    return dict(cap=cap, wall_s=wall,
                refined=[(m.stamp, list(m.data)) for m in refined],
                kept=[(m.stamp, m.data.points, m.data.labels,
                       np.array(m.data.confidences)) for m in kept],
                processed=graph.nodes["capture"].processed)


def check_tools_graph(work, images, boxes, cpu_codes, dev) -> dict:
    """Check (d): the graph on ``dev`` and on the CPU, both float32 with the
    head fitted to the same CPU codes: the captured JPEGs byte-equal to
    ``jpeg.encode`` of each frame, the refined rects equal, the kept
    proposals' rects and labels equal and their probabilities within
    TOOLS_PROB_ATOL, at least one proposal kept."""
    from torchfcn.data import jpeg
    card = tools_graph(work, images, boxes, cpu_codes, dev)
    cpu = tools_graph(work, images, boxes, cpu_codes, "cpu")
    written = [open(os.path.join(card["cap"], f"{k:08d}.jpg"), "rb").read()
               for k in range(card["processed"])]
    if card["processed"] != TOOLS_GRAPH_FRAMES or written != [
            jpeg.encode(img, 95) for img in images[:TOOLS_GRAPH_FRAMES]]:
        raise AssertionError(f"tools: the capture node wrote "
                             f"{card['processed']} frames, not the JPEGs of "
                             f"the {TOOLS_GRAPH_FRAMES} published")
    if card["refined"] != cpu["refined"] or \
            len(card["refined"]) != TOOLS_GRAPH_FRAMES - 1:
        raise AssertionError(f"tools: refined rects {card['refined']} on "
                             f"{dev}, {cpu['refined']} on the CPU")
    n_kept = sum(len(labels) for _, _, labels, _ in card["kept"])
    if len(card["kept"]) != TOOLS_GRAPH_FRAMES or n_kept < 1:
        raise AssertionError(f"tools: the roi_classifier node published "
                             f"{card['kept']}")
    if [k[:3] for k in card["kept"]] != [k[:3] for k in cpu["kept"]]:
        raise AssertionError(f"tools: kept proposals {card['kept']} on "
                             f"{dev}, {cpu['kept']} on the CPU")
    prob_err = max(float(np.abs(a[3] - b[3]).max(initial=0.0))
                   for a, b in zip(card["kept"], cpu["kept"]))
    if not prob_err <= TOOLS_PROB_ATOL:
        raise AssertionError(f"tools: kept probabilities {prob_err} apart "
                             f"(limit {TOOLS_PROB_ATOL})")
    log("tools", f"launch graph capture + boundary_refinement + "
        f"roi_classifier over {TOOLS_GRAPH_FRAMES} fixture frames in "
        f"float32: JPEGs byte-equal to jpeg.encode, {len(card['refined'])} "
        f"refined rects and {n_kept} kept proposals' rects and labels equal "
        f"to the CPU graph's, probabilities max |d| {prob_err:.3g} (limit "
        f"{TOOLS_PROB_ATOL}); {card['wall_s']:.2f} s on {dev}, "
        f"{cpu['wall_s']:.2f} s on the CPU")
    return dict(frames=TOOLS_GRAPH_FRAMES, refined=len(card["refined"]),
                kept=n_kept, prob_max_abs_err=prob_err,
                limits=dict(prob_atol=TOOLS_PROB_ATOL),
                wall_s=card["wall_s"], cpu_wall_s=cpu["wall_s"])


def tools_timings(crops: list, card: str) -> dict:
    """Check (e): codes per second (host resize, transfer, forward, codes
    back; median of 3 calls after one), the host's resize and copy, and
    device busy per call (one profile of a call at each of TOOLS_BATCHES,
    each in a range of its own) in bf16 and float32."""
    from torchfcn.serve.profile import range_device_us
    from torchfcn.tools.features import CnnCodeExtractor
    rows = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        ext = CnnCodeExtractor(dtype=dtype, device="cuda")
        batches = {}
        for n in TOOLS_BATCHES:
            part = crops[:n]
            ext(part)
            times = []
            for _ in range(3):
                t = time.perf_counter()
                ext(part)
                times.append(time.perf_counter() - t)
            t = time.perf_counter()
            batches[n] = ext.batch(part)
            torch.cuda.synchronize()
            rows[f"{name}_b{n}"] = dict(
                codes_s=n / statistics.median(times),
                wall_ms=1e3 * statistics.median(times),
                resize_ms=1e3 * (time.perf_counter() - t))

        def calls():
            with ext.policy.precision():
                for n, batch in batches.items():
                    with torch.profiler.record_function(f"tools B={n};"):
                        ext.codes(batch)

        prof, _ = device_profile(calls, f"tools: codes {name}")
        for n in TOOLS_BATCHES:
            row = rows[f"{name}_b{n}"]
            row["busy_ms"] = range_device_us(prof, f"tools B={n};") / 1e3
            row["idle_share"] = 1 - row["busy_ms"] / row["wall_ms"]
    log("tools", f"codes at 224x224 on {card}: " + "; ".join(
        f"{k} {v['codes_s']:.1f} codes/s ({v['wall_ms']:.2f} ms a call, "
        f"device busy {v['busy_ms']:.3f} ms, host resize and copy "
        f"{v['resize_ms']:.2f} ms)" for k, v in rows.items()))
    return rows


def phase_tools(counters, card: str) -> dict:
    """The label tools on the card; returns their readings."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="torchfcn_tools_")
    for c in counters.values():
        c.launches = 0
    paths, images, boxes, crops = fixture_crops()
    codes, cpu_codes = tools_codes(crops, "cuda")
    refine = tools_refine(work, "cuda")
    rank = tools_rank(work, paths, boxes, "cuda")
    graph = check_tools_graph(work, images, boxes, cpu_codes, "cuda")
    launches = {k: c.launches for k, c in counters.items()}
    shutil.rmtree(work)
    timings = tools_timings(crops, card)
    seconds = time.perf_counter() - t_phase
    log("tools", f"phase took {seconds:.1f} s; kernel launches {launches} "
        f"(the tools' path runs none of the four); on {card}")
    return dict(codes=codes, refine=refine, rank=rank, graph=graph,
                timings=timings, launches=launches, seconds=seconds)


# --- 15. compositor: the host compositor, train --manifest, host gate ---

# sha256 of hard_pipeline's first batch at 448x448, B = 16, seed 1 (its
# arrays in key order, batch_digest): recorded on the CPU by
# tests/test_torch_host_compositor.py, so the card's host must compose the
# very scenes the tests compose
COMPOSITOR_DIGEST = \
    "0b68db59ea25e33dd54914f3972e7672eb34f2403da5f49fe3f7133f416a1517"
COMPOSITOR_BATCH, COMPOSITOR_TIMED = 16, 4
COMPOSITOR_GEOMETRIES = ((224, 16), (288, 8))
# train --manifest on the host compositor: steps and batch
MANIFEST_STEPS, MANIFEST_BATCH = 20, 8
# the googlenet_3cls gate unit on host scenes (host-cached training scenes,
# the host held-out set) must read above this mAP, its untrained net below
# it: below the card's reading (exact 0.1946, the untrained net 0.0, in
# the first run of this phase; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md,
# section 6)
HOST_GATE_MAP_LIMIT = 0.12
# the JAX package's recorded reading of the same family (GATES_LATEST.json:
# 96 held-out images, one seed; the file does not name its steps), printed
# beside the port's as a reference, not a bound
JAX_GATE_PIN = {"exact": 0.1992, "fp8": 0.1654, "n_gt": 340,
                "eval_images": 96}


def batch_digest(batch: dict) -> str:
    """sha256 over a batch's arrays, in key order, each key then its
    bytes."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def host_compositor_cost(root: str, card: str) -> dict:
    """hard_pipeline on the host: its first batch at 448x448 (B = 16, seed
    1) against COMPOSITOR_DIGEST, host ms per batch and per scene (median
    of COMPOSITOR_TIMED batches), and per scene at the other gate
    geometries."""
    from torchfcn.core.config import GridConfig
    from torchfcn.data.hardbench import hard_pipeline, hard_sources
    t = time.perf_counter()
    hard_sources(root)
    sources_s = time.perf_counter() - t
    pipe = hard_pipeline(root, GridConfig(NET, NET, 16, 4),
                         batch_size=COMPOSITOR_BATCH, seed=1)
    walls, digest = [], None
    for _ in range(COMPOSITOR_TIMED):
        t = time.perf_counter()
        batch = pipe.batch(COMPOSITOR_BATCH)
        walls.append(time.perf_counter() - t)
        digest = digest or batch_digest(batch)
    if digest != COMPOSITOR_DIGEST:
        raise AssertionError(f"compositor: the first batch's digest {digest} "
                             f"is not the one the CPU tests record")
    batch_ms = 1e3 * statistics.median(walls)
    row = dict(sources_s=sources_s, digest=digest, batch=COMPOSITOR_BATCH,
               batch_ms=batch_ms, scene_ms={
                   str(NET): batch_ms / COMPOSITOR_BATCH})
    for im, stride in COMPOSITOR_GEOMETRIES:
        pipe = hard_pipeline(root, GridConfig(im, im, stride, 4),
                             batch_size=COMPOSITOR_BATCH, seed=1)
        t = time.perf_counter()
        pipe.batch(COMPOSITOR_BATCH)
        row["scene_ms"][str(im)] = 1e3 * (time.perf_counter() - t) / \
            COMPOSITOR_BATCH
    log("compositor", f"hard_pipeline on the host: sources rendered in "
        f"{sources_s:.2f} s; {NET}x{NET} B={COMPOSITOR_BATCH} seed 1: first "
        f"batch's digest equal to the CPU tests'; {batch_ms:.1f} ms a batch "
        f"(median of {COMPOSITOR_TIMED}), ms a scene " + ", ".join(
            f"{k}x{k} {v:.1f}" for k, v in row["scene_ms"].items())
        + f"; on {card}")
    return row


def manifest_files(root: str, work: str) -> tuple:
    """The hard sources written as PNGs with a mask manifest (the JAX
    package's layout): (manifest path, background paths)."""
    from torchfcn.data.hardbench import hard_sources
    from torchfcn.data.imageio import imwrite
    src = hard_sources(root)
    samples, names = src.names()
    lines = []
    for s in samples:
        for name in (s.image_path, s.mask_path):
            imwrite(os.path.join(work, name), src.imread(name))
        x, y, w, h = (int(v) for v in s.rect)
        lines += [f"{os.path.join(work, s.image_path)} "
                  f"{os.path.join(work, s.mask_path)} {s.label + 1} "
                  f"{x} {y} {w} {h}", ""]
    backgrounds = []
    for name in names:
        backgrounds.append(os.path.join(work, name))
        imwrite(backgrounds[-1], src.imread(name))
    manifest = os.path.join(work, "train.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return manifest, backgrounds


def manifest_training(root: str, counters, card: str, workers: int = 0,
                      phase: str = "compositor") -> dict:
    """``cli train --manifest`` (no --device-data) on the card, fed by the
    host compositor (in this process, or in ``workers`` processes), under
    torch.profiler: finite losses, steps/s and the device's idle share
    over the command and over the Trainer's loop."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="torchfcn_manifest_")
    manifest, backgrounds = manifest_files(root, work)
    metrics = os.path.join(work, "metrics.jsonl")
    argv = ["train", "--recipe", "bounding_box", "--manifest", manifest,
            "--backgrounds", *backgrounds, "--max-iter", str(MANIFEST_STEPS),
            "--batch-size", str(MANIFEST_BATCH), "--snapshot-dir",
            os.path.join(work, "snap"), "--metrics-out", metrics,
            "--workers", str(workers), "--device", "cuda"]
    for c in counters.values():
        c.launches = 0
    out = []
    t = time.perf_counter()
    _, rows = device_profile(lambda: out.append(cli_json(argv)),
                             f"{phase}: train --manifest")
    wall = time.perf_counter() - t
    launches = {k: c.launches for k, c in counters.items()}
    trained = json.loads(out[-1][-1])
    with open(metrics) as f:
        history = [json.loads(line) for line in f]
    shutil.rmtree(work)
    losses = [{k: v for k, v in h.items() if k.startswith("loss")}
              for h in history]
    if trained["trained_to"] != MANIFEST_STEPS or not losses or not all(
            l and np.isfinite(list(l.values())).all() for l in losses):
        raise AssertionError(f"{phase}: train --manifest gave {trained}, "
                             f"losses {losses}")
    busy = sum(us for _, us, _ in rows) / 1e3
    # the Trainer's own clock, from its construction to the last step (its
    # display's img/s): the command's wall less the CLI's set-up, the
    # snapshot and the profile's processing
    loop = MANIFEST_STEPS * MANIFEST_BATCH / history[-1]["img_per_sec"]
    row = dict(steps=MANIFEST_STEPS, batch=MANIFEST_BATCH, workers=workers,
               wall_s=wall, steps_s=MANIFEST_STEPS / wall, losses=losses,
               busy_ms=busy, idle_share=1 - busy / (1e3 * wall),
               loop_s=loop, loop_ms_step=1e3 * loop / MANIFEST_STEPS,
               loop_idle_share=1 - busy / (1e3 * loop), launches=launches)
    log(phase, f"cli train --recipe bounding_box --manifest --workers "
        f"{workers} (host compositor) B={MANIFEST_BATCH} 224x224, "
        f"{MANIFEST_STEPS} steps in "
        f"{wall:.2f} s under torch.profiler ({row['steps_s']:.2f} steps/s, "
        f"model build and composition included): losses {losses}; device "
        f"busy {busy:.1f} ms, idle {100 * row['idle_share']:.1f} %; the "
        f"Trainer's loop {loop:.2f} s ({row['loop_ms_step']:.1f} ms a step "
        f"from its construction, idle {100 * row['loop_idle_share']:.1f} "
        f"%); kernel launches {launches} (vgg_detectnet_train has no LRN); "
        f"on {card}")
    return row


def host_gate(root: str, counters, card: str) -> dict:
    """The googlenet_3cls gate unit in the JAX package's own mode: its
    capture configuration (seed 0) trained on host-cached scenes and scored
    on the host held-out set, exact and e5m2; each training and scoring
    counted, each kernel held against its plain version on the scoring's
    recorded inputs; the untrained net's mAP on the same set."""
    from torchfcn.serve import detector as detector_module
    from torchfcn.train import gates
    cfgs = gates.bench_gate_configs("bench")
    _, cfg = gate_cfg(cfgs, GATE_DET)
    model = cfg.pop("model")
    g, grid = gates._gate_geometry("detection", cfg | {"model": model})
    seconds = {}
    t = time.perf_counter()
    gates._cached_host_batches(root, grid, classes=g["classes"],
                               batch=g["batch"], n_cached=g["n_cached"],
                               seed=1000, log=lambda m: None)
    seconds["compose_train"] = time.perf_counter() - t
    t = time.perf_counter()
    images, gts, _ = gates.held_out_set(root, grid, g["classes"],
                                        g["eval_images"])
    seconds["compose_eval"] = time.perf_counter() - t
    scenes = g["n_cached"] * g["batch"] + g["eval_images"]
    trains, scorings, nms, inputs = [], [], [], []
    t = time.perf_counter()
    with counted_calls(gates, "_train_hard", counters, trains), \
            counted_calls(gates, "_score_detector", counters, scorings), \
            scoring_inputs(inputs), \
            recorded_calls(detector_module, "vote_boxes_batched", nms):
        det = gates.detection_gate(model, root=root, seeds=(0,),
                                   device="cuda", **cfg)
    seconds["unit"] = time.perf_counter() - t
    seconds.update(train=det["train_s"], eval=det["eval_s"])
    chunks = -(-det["eval_images"] // 32)
    per_step = {k: v / cfg["steps"] for k, v in trains[0].items()}
    exact_l, fp8_l = scorings
    if per_step["lrn"] != 1 or per_step["lrn_maxpool"] != 1:
        raise AssertionError(f"compositor: LRN kernels launched {per_step} "
                             f"times a training step, not once each")
    if exact_l["group_rects"] != chunks or fp8_l["group_rects"] != chunks \
            or fp8_l["stem_tail"] != chunks:
        raise AssertionError(f"compositor: scorings launched {exact_l} / "
                             f"{fp8_l} in {chunks} chunks")
    first = nms[0]
    rects = first["propose_boxes"].float().contiguous().clone()
    valid = first["valid"].contiguous().clone()
    if not bool(valid.any()):
        raise AssertionError("compositor: the trained model's first scoring "
                             "chunk has no valid NMS candidate")
    exact_in, fp8_in = inputs
    against_plain = dict(
        group_rects=dict(shape=list(rects.shape), valid_candidates=int(
            valid.sum()), **check_group_rects(
                rects, valid, f"the host-trained {model}'s first scoring "
                f"chunk ({int(valid.sum())} valid candidates)", timed=False,
                group_threshold=first["group_threshold"], eps=first["eps"])),
        **check_recorded_lrn(exact_in, 32, "compositor",
                             f"the host-trained {model}'s first exact "
                             f"scoring chunk"),
        stem_tail=check_recorded_stem(fp8_in["stem_tail_cuda"], 32,
                                      "compositor"))
    step0, _ = gates._score_detector(
        model, initial_params(root, "detection", cfg | {"model": model}),
        grid, images, gts, g["classes"], {"num_classes": grid.num_classes})
    det.update(step0_mAP=round(step0, 4),
               steps_s=cfg["steps"] / det["train_s"],
               launches_per_train_step=per_step,
               scoring_launches={"exact": exact_l, "fp8": fp8_l},
               scoring_chunks=chunks, against_plain=against_plain,
               seconds=seconds, scenes=scenes,
               host_s_per_scene=(seconds["compose_train"]
                                 + seconds["compose_eval"]) / scenes,
               jax_pin=JAX_GATE_PIN)
    log("compositor", f"gate unit {model} in the JAX package's mode: "
        f"{g['n_cached']} batches of {g['batch']} host scenes composed and "
        f"cached in {seconds['compose_train']:.1f} s, {g['eval_images']} "
        f"held-out host scenes in {seconds['compose_eval']:.1f} s "
        f"({1e3 * det['host_s_per_scene']:.1f} ms a scene); {cfg['steps']} "
        f"steps lr {cfg['lr']:g} in {det['train_s']} s; mAP exact "
        f"{det['exact']['mAP']} ({det['n_det']} detections, {det['n_gt']} "
        f"boxes), fp8 {det['fp8']['mAP']}, step 0 {det['step0_mAP']}; limit "
        f"{HOST_GATE_MAP_LIMIT}; the JAX package's recorded reading (not a "
        f"bound): exact {JAX_GATE_PIN['exact']}, fp8 {JAX_GATE_PIN['fp8']} "
        f"over {JAX_GATE_PIN['n_gt']} boxes of {JAX_GATE_PIN['eval_images']} "
        f"images; unit wall {seconds['unit']:.1f} s; on {card}")
    if not det["step0_mAP"] < HOST_GATE_MAP_LIMIT < det["exact"]["mAP"]:
        raise AssertionError(
            f"compositor: mAP {det['step0_mAP']} at step 0 and "
            f"{det['exact']['mAP']} trained do not straddle the limit "
            f"{HOST_GATE_MAP_LIMIT}")
    return det


def phase_compositor(counters, card: str) -> dict:
    """The host compositor on the card's host and the paths it feeds;
    returns their readings."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="torchfcn_compositor_")
    cost = host_compositor_cost(root, card)
    manifest = manifest_training(root, counters, card)
    gate = host_gate(root, counters, card)
    shutil.rmtree(root)
    seconds = time.perf_counter() - t_phase
    log("compositor", f"phase took {seconds:.1f} s")
    return dict(cost=cost, manifest=manifest, gate=gate,
                limits=dict(mAP=HOST_GATE_MAP_LIMIT), seconds=seconds)


# --- 16. inputs: the worker pool, e5m2 without store_stem2, video ---

# the worker pool: a small pool (net, batch, least batches read) held batch
# by batch against each worker's serial pipeline, read until each worker
# has sent POOL_SMALL_EACH batches (at most POOL_SMALL_MAX in all: a worker
# that starts late finds the queue filled by the other); scenes/s at these
# worker
# counts at NET x NET, B = BATCH, over POOL_BATCHES_PER_WORKER batches a
# worker after the first; train --manifest through POOL_TRAIN_WORKERS
POOL_SMALL = (64, 2, 6)
POOL_SMALL_EACH, POOL_SMALL_MAX = 2, 400
POOL_WORKERS = (1, 2, 4, 8)
POOL_BATCHES_PER_WORKER = 4
POOL_TRAIN_WORKERS = 8
# e5m2 storage without store_stem2: the first STEM2_CPU_FRAMES frames'
# heads on the card within STEM2_HEAD_TOL of their largest magnitude of the
# CPU's, and nearer the CPU's on average than e5m2 storage moves the CPU's
# own heads (its exact bf16 heads: the control)
STEM2_CPU_FRAMES = 2
STEM2_HEAD_TOL = 3e-2
# the video fixture (tests/fixtures/video/README.md); the sha256 of its
# frames as cv.VideoCapture(path) decodes them (FFmpeg), and of
# video_without_dht's copy: recorded on the CPU by tests/test_torch_video.py
VIDEO_FIXTURE = os.path.join(REPO_ROOT, "tests", "fixtures", "video",
                             "voc_mini_15fps.avi")
VIDEO_FRAMES, VIDEO_FPS = 12, 15.0
VIDEO_FRAMES_SHA256 = \
    "432546ac96f9f9e29aa24ae735f87b0a0724727d0f34db0b3e87f112a7fa23fd"
VIDEO_STRIPPED_SHA256 = \
    "a953846bbc8f77f3dca7b57aca44f77a56c023fa196750efc2477f57fb833251"
VIDEO_DECODE_REPS = 3
# launch --video's decimation
VIDEO_STRIDE, VIDEO_MAX = 2, 5
# the sha256 of viz.draw_detections(*overlay_case()), recorded on the CPU
# from tpufcn's cv2 drawing by tests/test_torch_viz.py; timing repeats
OVERLAY_SHA256 = \
    "09777e27f7aa7f5d0cd36686da787fd3a0717db5175c05cd05cbe1d3ff6e0077"
OVERLAY_REPS = 20
LAUNCH_SPEC = os.path.join(REPO_ROOT, "examples",
                           "fcn_object_detector.launch.json")


def frames_digest(frames) -> str:
    """sha256 over the frames' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()


def jpeg_without_dht(data: bytes) -> bytes:
    """A JPEG file with the DHT segments before its first scan cut out."""
    import struct
    out, pos = [data[:2]], 2
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if data[pos + 1] != 0xC4:
            out.append(data[pos:pos + 2 + length])
        pos += 2 + length
    out.append(data[pos:])
    return b"".join(out)


def rewrite_avi(data: bytes, frame_fn) -> bytes:
    """``data``'s RIFF tree with each frame chunk (``##dc`` / ``##db`` in
    ``LIST movi``) replaced by ``frame_fn(body)``; the sizes of the lists
    around them and the ``idx1`` entries (offset from ``movi``, size)
    follow."""
    import struct
    out, moved = bytearray(), {}

    def chunk(pos: int, movi_old, movi_new) -> int:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        start = len(out)
        out.extend(fourcc + bytes(4))
        if fourcc in (b"RIFF", b"LIST"):
            kind = data[pos + 8:pos + 12]
            out.extend(kind)
            if kind == b"movi":
                movi_old, movi_new = pos + 8, start + 8
            inner, end = pos + 12, pos + 8 + size
            while inner + 8 <= end:
                inner = chunk(inner, movi_old, movi_new)
        else:
            body = data[pos + 8:pos + 8 + size]
            if movi_old is not None and fourcc[2:] in (b"dc", b"db"):
                body = frame_fn(body)
                moved[pos - movi_old] = (start - movi_new, len(body))
            elif fourcc == b"idx1":
                body = bytearray(body)
                for e in range(0, len(body) - 15, 16):
                    old = struct.unpack_from("<II", body, e + 8)
                    struct.pack_into("<II", body, e + 8,
                                     *moved.get(old[0], old))
            out.extend(body)
        n = len(out) - start - 8
        struct.pack_into("<I", out, start + 4, n)
        if n & 1:
            out.append(0)
        return pos + 8 + size + (size & 1)

    pos = 0
    while pos + 8 <= len(data):
        pos = chunk(pos, None, None)
    return bytes(out)


def video_without_dht(data: bytes) -> bytes:
    """The MJPG AVI ``data`` as a camera writes it: each frame re-encoded
    with Annex K's Huffman tables (``jpeg.encode``, ``cv.imencode`` at q95)
    and their DHT segments cut out.  (The fixture's own frames carry
    optimised tables, so cutting those out would leave frames that decode
    to other pixels.)"""
    from torchfcn.data import jpeg
    return rewrite_avi(data, lambda frame: jpeg_without_dht(
        jpeg.encode(jpeg.decode(frame))))


def check_reaped(procs: list, what: str) -> None:
    """Raises if a pool's process is alive, unreaped or still a child."""
    import multiprocessing as mp
    live = {c.pid for c in mp.active_children()}
    left = [p.pid for p in procs
            if p.is_alive() or p.exitcode is None or p.pid in live]
    if left:
        raise AssertionError(f"inputs: {what} left processes {left} after "
                             f"close()")


def pool_streams(samples, backgrounds, work: str, card: str) -> dict:
    """POOL_SMALL through 2 workers (depth 2): every batch received is, by
    digest, the next batch of exactly one worker's serial
    ``CompositeTrainPipeline(seed + 1000 * w)``, and both workers
    contribute; a worker's error (a missing file) reaches the consumer as
    RuntimeError with its traceback; no process is left after close()."""
    from torchfcn.core.config import GridConfig
    from torchfcn.data.hardbench import BOX_CAPACITY, hard_data_config
    from torchfcn.data.manifest import MaskSample
    from torchfcn.data.parallel import ParallelCompositePipeline
    from torchfcn.data.pipeline import CompositeTrainPipeline
    net, batch, n = POOL_SMALL
    grid, cfg = GridConfig(net, net, 16, 4), hard_data_config(batch)
    seed, workers = SEED + 3, 2
    serial = [CompositeTrainPipeline(samples, grid, cfg,
                                     backgrounds=backgrounds,
                                     box_capacity=BOX_CAPACITY,
                                     seed=seed + 1000 * w)
              for w in range(workers)]
    pending = [batch_digest(p.batch(batch)) for p in serial]
    owners = []
    t = time.perf_counter()
    with ParallelCompositePipeline(samples, grid, cfg,
                                   backgrounds=backgrounds,
                                   box_capacity=BOX_CAPACITY,
                                   workers=workers, depth=2,
                                   seed=seed) as pool:
        for b in pool:
            d = batch_digest(b)
            if pending.count(d) != 1:
                raise AssertionError(
                    f"inputs: the pool's batch {len(owners)} is the next "
                    f"batch of {pending.count(d)} workers' serial "
                    f"pipelines, not of one")
            owners.append(pending.index(d))
            pending[owners[-1]] = batch_digest(
                serial[owners[-1]].batch(batch))
            if len(owners) >= n and min(owners.count(w) for w in range(
                    workers)) >= POOL_SMALL_EACH:
                break
            if len(owners) == POOL_SMALL_MAX:
                raise AssertionError(f"inputs: {POOL_SMALL_MAX} batches of "
                                     f"the pool came from workers "
                                     f"{sorted(set(owners))} alone")
    wall = time.perf_counter() - t
    check_reaped(pool._procs, "the small pool")
    n = len(owners)
    bad = [MaskSample(os.path.join(work, "missing.png"),
                      os.path.join(work, "missing_mask.png"), 0,
                      np.array([1, 1, 8, 8], np.int32))]
    with ParallelCompositePipeline(bad, grid, hard_data_config(1),
                                   workers=1, depth=2) as faulty:
        try:
            faulty.batch()
        except RuntimeError as e:
            relayed = str(e)
        else:
            raise AssertionError("inputs: a worker's error was not relayed")
    if not relayed.startswith("scene-builder worker failed") \
            or "Traceback" not in relayed:
        raise AssertionError(f"inputs: the relayed error reads {relayed!r}")
    check_reaped(faulty._procs, "the faulty pool")
    log("inputs", f"worker pool, {workers} workers, {net}x{net} B={batch}: "
        f"{n} batches in {wall:.2f} s (spawn included) from workers "
        f"{[owners.count(w) for w in range(workers)]} (batches each), each "
        f"by digest the next batch of that worker's serial "
        f"CompositeTrainPipeline(seed + 1000 w); a worker's missing file "
        f"relayed as RuntimeError with its traceback; no process left after "
        f"close(); on {card}")
    return dict(workers=workers, batches=n, owners=owners, wall_s=wall,
                relayed=relayed.splitlines()[-1])


def pool_throughput(samples, backgrounds, card: str) -> dict:
    """Composed scenes a second at NET x NET, B = BATCH (hard_data_config,
    the PNG sources): one serial pipeline in this process (its second
    batch), then a pool of each of POOL_WORKERS workers (``throughput``
    over POOL_BATCHES_PER_WORKER batches a worker, after a first batch,
    whose wait from the pool's start is reported apart)."""
    from torchfcn.core.config import GridConfig
    from torchfcn.data.hardbench import BOX_CAPACITY, hard_data_config
    from torchfcn.data.parallel import ParallelCompositePipeline
    from torchfcn.data.pipeline import CompositeTrainPipeline
    grid, cfg = GridConfig(NET, NET, 16, 4), hard_data_config(BATCH)
    kw = dict(backgrounds=backgrounds, box_capacity=BOX_CAPACITY, seed=SEED)
    serial = CompositeTrainPipeline(samples, grid, cfg, **kw)
    serial.batch(BATCH)                 # the background cache filled
    t = time.perf_counter()
    serial.batch(BATCH)
    rows = {"serial": dict(scenes_s=BATCH / (time.perf_counter() - t))}
    for workers in POOL_WORKERS:
        t = time.perf_counter()
        with ParallelCompositePipeline(samples, grid, cfg, workers=workers,
                                       **kw) as pool:
            pool.batch()
            first_s = time.perf_counter() - t
            rate = pool.throughput(POOL_BATCHES_PER_WORKER * workers)
        check_reaped(pool._procs, f"the pool of {workers}")
        rows[str(workers)] = dict(scenes_s=rate, first_batch_s=first_s,
                                  wall_s=time.perf_counter() - t)
    log("inputs", f"scenes/s at {NET}x{NET} B={BATCH} (hard_data_config, "
        f"PNG sources): " + ", ".join(
            f"{k} {v['scenes_s']:.2f}" + (f" (first batch after "
                                          f"{v['first_batch_s']:.2f} s)"
                                          if "first_batch_s" in v else "")
            for k, v in rows.items()) + f"; on {card}")
    return rows


def stem2_detector(rng, counters, card: str) -> dict:
    """``Detector("googlenet_detectnet", model_kwargs={"store_dtype":
    e5m2})`` (store_stem2 False, bf16 compute) on BATCH seeded NET x NET
    frames: the lrn, lrn_maxpool and groupRectangles kernels once each,
    the stem tail never; LRN1's input e5m2 values widened to bf16; both
    LRN kernels against their plain versions on their recorded inputs;
    detections equal to decode + NMS of the same heads on the CPU; the
    first STEM2_CPU_FRAMES frames' heads against the port's CPU path, with
    e5m2 storage's own effect on the CPU (exact bf16 heads) as the
    control; batch latency and device busy."""
    from torchfcn.models import layers
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.profile import bias_heads
    what = "googlenet_detectnet e5m2 without store_stem2"
    kw = {"store_dtype": torch.float8_e5m2}
    det = Detector("googlenet_detectnet", max_candidates=K,
                   dtype=torch.bfloat16, rng_seed=SEED, device="cuda",
                   model_kwargs=kw)
    bias_heads(det)
    frames = rng.integers(0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)
    calls = {"lrn_cuda": [], "lrn_maxpool_cuda": []}
    with recorded_calls(layers, "lrn_cuda", calls["lrn_cuda"]), \
            recorded_calls(layers, "lrn_maxpool_cuda",
                           calls["lrn_maxpool_cuda"]):
        res, launches = run_counted(det, frames, counters,
                                    ("lrn", "lrn_maxpool", "group_rects"),
                                    what)
    if launches["stem_tail"] or any(launches[k] != 1 for k in (
            "lrn", "lrn_maxpool", "group_rects")):
        raise AssertionError(f"inputs: {what} launched {launches}")
    x = calls["lrn_cuda"][0]["x"]
    if x.dtype != torch.bfloat16 or not torch.equal(
            x, x.to(torch.float8_e5m2).to(torch.bfloat16)):
        raise AssertionError(f"inputs: {what}: LRN1 read {x.dtype} values "
                             f"that are not e5m2's")
    plain = check_recorded_lrn(calls, BATCH, "inputs", what)
    heads = check_against_cpu(det, frames, res, what)
    n = STEM2_CPU_FRAMES
    state = {k: v.cpu() for k, v in det.model.state_dict().items()}
    cpu_heads = []
    for model_kwargs in (kw, None):
        cpu = Detector("googlenet_detectnet", config=det.config,
                       dtype=torch.bfloat16, rng_seed=SEED, device="cpu",
                       model_kwargs=model_kwargs)
        cpu.model.load_state_dict(state)
        with torch.inference_mode():
            cpu_heads.append(cpu._forward(torch.from_numpy(frames[:n])))
    against_cpu = {}
    for name, card_h, want, exact in zip(("coverage", "bboxes"), heads,
                                         *cpu_heads):
        got = card_h[:n].float().cpu()
        scale = float(want.float().abs().max())
        err = float((got - want.float()).abs().max()) / scale
        mean = float((got - want.float()).abs().mean())
        storage = float((want.float() - exact.float()).abs().mean())
        against_cpu[name] = dict(max_err_of_scale=err, mean_abs_err=mean,
                                 storage_mean_abs=storage,
                                 equal_share=float((got == want.float())
                                                   .float().mean()))
        if not (err <= STEM2_HEAD_TOL and mean < storage):
            raise AssertionError(f"inputs: {what}: {name} on the card "
                                 f"against the cpu {against_cpu[name]}, "
                                 f"bound {STEM2_HEAD_TOL} of scale")
    latency = batch_latency(det, frames)
    busy = busy_ms(lambda: det(frames))
    log("inputs", f"Detector {what}, bf16 compute, B={BATCH} {NET}x{NET} "
        f"K={K}: {int(res.valid.sum())} detections equal to decode+NMS of "
        f"the same heads on the cpu; launches {launches}; LRN kernels "
        f"against plain on their recorded inputs "
        f"{ {k: v['bit_equal_share'] for k, v in plain.items()} } bit-equal; "
        f"heads of {n} frames against the cpu's {against_cpu} (bound "
        f"{STEM2_HEAD_TOL} of scale); {latency * 1e3:.3f} ms a batch (median "
        f"of {REPS}, host clock), device busy {busy:.3f} ms; on {card}")
    return dict(launches=launches, detections=int(res.valid.sum()),
                against_plain=plain, against_cpu=against_cpu,
                latency_ms=latency * 1e3, busy_ms=busy)


def video_inputs(counters, card: str, work: str) -> dict:
    """The video fixture through ``torchfcn.serve.video`` (its frames and
    a copy without Huffman tables against the recorded digests, its stamps,
    host ms a frame), the flagship graph fed its frames (replay --video's
    graph: each RectsMsg against direct Detector calls, the kernels against
    their plain versions on the last dispatch), then ``cli replay --video``
    and ``cli launch --video`` over examples/fcn_object_detector.launch.json
    on firing weights, with the stamps published, each overlay against
    draw_detections and the kernels against their plain versions on the
    graph's last dispatch."""
    from torchfcn.models import layers
    from torchfcn.serve import bus as bus_module
    from torchfcn.serve import detector
    from torchfcn.serve.video import read_video_frames
    frames, stamps = read_video_frames(VIDEO_FIXTURE)
    want = [i / VIDEO_FPS for i in range(VIDEO_FRAMES)]
    if len(frames) != VIDEO_FRAMES or stamps != want \
            or frames_digest(frames) != VIDEO_FRAMES_SHA256:
        raise AssertionError(f"inputs: the video fixture read as "
                             f"{len(frames)} frames, stamps {stamps}, not "
                             f"the recorded ones")
    with open(VIDEO_FIXTURE, "rb") as f:
        stripped = video_without_dht(f.read())
    path = os.path.join(work, "no_dht.avi")
    with open(path, "wb") as f:
        f.write(stripped)
    sframes, sstamps = read_video_frames(path)
    if sstamps != want or frames_digest(sframes) != VIDEO_STRIPPED_SHA256:
        raise AssertionError("inputs: the video without Huffman tables did "
                             "not read as recorded")
    walls = []
    for _ in range(VIDEO_DECODE_REPS):
        t = time.perf_counter()
        read_video_frames(VIDEO_FIXTURE)
        walls.append(time.perf_counter() - t)
    decode_ms = 1e3 * statistics.median(walls) / VIDEO_FRAMES
    _, _, replayed, calls = replay_graph(
        "googlenet_detectnet", counters, frames,
        ("lrn", "lrn_maxpool", "group_rects"), ("stem_tail",),
        "replay --video graph googlenet_detectnet bf16 K=256", record=True)
    against_plain = stream_kernels(calls, "inputs")
    replay_out = json.loads(cli_json(["replay", "--video", VIDEO_FIXTURE,
                                      "--device", "cuda"])[-1])
    if replay_out != {"frames_processed": VIDEO_FRAMES}:
        raise AssertionError(f"inputs: cli replay --video printed "
                             f"{replay_out}")
    with open(LAUNCH_SPEC) as f:
        spec = json.load(f)
    params = spec["fcn_object_detector"]["params"]
    params["pretrained_weights"] = firing_snapshot(work)
    spec_path = os.path.join(work, "detector.launch.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    published = []
    calls = {"lrn_cuda": [], "lrn_maxpool_cuda": [],
             "vote_boxes_batched": []}
    with contextlib.ExitStack() as stack:
        stack.enter_context(recorded_calls(bus_module.TopicBus, "publish",
                                           published))
        for module, fn in ((layers, "lrn_cuda"), (layers, "lrn_maxpool_cuda"),
                           (detector, "vote_boxes_batched")):
            stack.enter_context(recorded_calls(module, fn, calls[fn]))
        launch_out = json.loads(cli_json([
            "launch", spec_path, "--video", VIDEO_FIXTURE, "--video-stride",
            str(VIDEO_STRIDE), "--max-frames", str(VIDEO_MAX), "--device",
            "cuda"])[-1])
    sent = [c["stamp"] for c in published if c["topic"] == "image"]
    if sent != want[::VIDEO_STRIDE][:VIDEO_MAX] \
            or launch_out["frames_published"] != VIDEO_MAX \
            or launch_out["processed"] != {"fcn_object_detector": VIDEO_MAX}:
        raise AssertionError(f"inputs: cli launch --video printed "
                             f"{launch_out}, stamps {sent}")
    overlays = launch_overlays(published, params["overlay_topic"])
    launch_plain = stream_kernels({k: v[-1:] for k, v in calls.items()},
                                  "inputs", batch=1)
    log("inputs", f"video {os.path.basename(VIDEO_FIXTURE)}: "
        f"{VIDEO_FRAMES} frames 320x240 at {VIDEO_FPS} fps, digest and "
        f"stamps as recorded, and of the copy without Huffman tables; "
        f"{decode_ms:.2f} ms a frame read and decoded on the host (median "
        f"of {VIDEO_DECODE_REPS} reads); cli replay --video: {replay_out}; "
        f"cli launch --video --video-stride {VIDEO_STRIDE} --max-frames "
        f"{VIDEO_MAX}: {launch_out['frames_published']} frames published "
        f"with stamps {sent}, processed {launch_out['processed']}, "
        f"{overlays['overlays']} overlays ({overlays['boxes']} boxes) each "
        f"equal to draw_detections of its frame and RectsMsg; on {card}")
    return dict(frames=VIDEO_FRAMES, decode_ms=decode_ms, replay=replayed,
                against_plain=against_plain, cli_replay=replay_out,
                cli_launch=launch_out, launch_stamps=sent,
                launch_overlays=overlays, launch_against_plain=launch_plain)


def firing_snapshot(work: str) -> str:
    """A Trainer snapshot directory of seeded googlenet_detectnet weights
    whose heads are scaled by 0.1 and biased, so that cells fire together
    (tests/test_torch_launch.py's weights)."""
    from torchfcn.models import build
    model = build("googlenet_detectnet")
    model.init_weights(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.cvg.weight.mul_(0.1)
        model.cvg.bias.fill_(8.0)
        model.bbox.weight.mul_(0.1)
        model.bbox.bias.copy_(torch.tensor([-24.0, -24.0, 120.0, 120.0])
                              .repeat(model.bbox.bias.numel() // 4))
    snap = os.path.join(work, "firing")
    os.makedirs(snap, exist_ok=True)
    torch.save({"step": 1, "params": model.state_dict()},
               os.path.join(snap, "1.pt"))
    return snap


def launch_overlays(published: list, topic: str) -> dict:
    """Each overlay a launch graph published (recorded TopicBus.publish
    calls) against ``viz.draw_detections`` of the frame and the RectsMsg
    published under its stamp; raises unless every frame has one and some
    draw boxes."""
    from torchfcn.serve.viz import draw_detections
    by_topic = {}
    for c in published:
        by_topic.setdefault(c["topic"], {})[c["stamp"]] = c["data"]
    frames, rects = by_topic.get("image", {}), by_topic.get(RECTS_TOPIC, {})
    overlays = by_topic.get(topic, {})
    if sorted(overlays) != sorted(frames) or sorted(rects) != sorted(frames):
        raise AssertionError(f"inputs: overlays at {sorted(overlays)}, "
                             f"rects at {sorted(rects)}, frames at "
                             f"{sorted(frames)}")
    boxes = 0
    for stamp, img in overlays.items():
        msg = rects[stamp]
        pts = msg.points
        dets = [([*pts[2 * i], *pts[2 * i + 1]], label, conf) for i, (
            label, conf) in enumerate(zip(msg.labels, msg.confidences))]
        if not np.array_equal(img, draw_detections(frames[stamp], dets)):
            raise AssertionError(f"inputs: the overlay at {stamp} is not "
                                 f"draw_detections of its frame and rects")
        boxes += len(dets)
    if not boxes:
        raise AssertionError("inputs: the launch graph drew no box")
    return dict(overlays=len(overlays), boxes=boxes)


def overlay_case() -> tuple:
    """(frame, detections, names) of the overlay's digest: a seeded
    448x448 frame; 8 boxes labelled 0 to 7 in bands 50 rows apart, so that
    no box covers an earlier text (8 names that hold the 95 printable ASCII
    characters), and 2 labelled 12 and 19 past the frame's edges."""
    rng = np.random.default_rng(SEED)
    frame = rng.integers(0, 256, (448, 448, 3), dtype=np.uint8)
    dets = []
    for label in range(8):
        x1, y1 = rng.uniform(2, 20), 40 + 50 * label + rng.uniform(0, 3)
        w, h = rng.uniform(0, 150), rng.uniform(0, 30)
        dets.append(([x1, y1, x1 + w, y1 + h], label,
                     float(rng.uniform(0, 6))))
    dets += [([300.5, 430.2, 500.9, 520.0], 12, 0.693),
             ([420.0, -20.0, 470.0, 20.7], 19, 2.5)]
    printable = "".join(chr(c) for c in range(32, 127))
    names = [printable[i:i + 12] for i in range(0, 95, 12)]
    return frame, dets, names


def overlay_outputs(card: str, work: str, snapshot: str) -> dict:
    """The overlay on the card's host: draw_detections of overlay_case
    against the digest recorded from tpufcn's cv2 drawing, its host ms;
    ``cli detect --overlay-dir`` over 2 video frames and ``cli train
    --records --inspect-data`` from records of them, on the card, each
    PNG read back against draw_detections of its frame and boxes."""
    from torchfcn.data.imageio import imread, imwrite
    from torchfcn.data.pipeline import RecordTrainPipeline
    from torchfcn.recipes import get as recipe
    from torchfcn.serve.video import read_video_frames
    from torchfcn.serve.viz import draw_detections
    case = overlay_case()
    if frames_digest([draw_detections(*case)]) != OVERLAY_SHA256:
        raise AssertionError("inputs: draw_detections of overlay_case is not "
                             "the recorded overlay")
    walls = []
    for _ in range(OVERLAY_REPS):
        t = time.perf_counter()
        draw_detections(*case)
        walls.append(time.perf_counter() - t)
    overlay_ms = 1e3 * statistics.median(walls)
    frames, _ = read_video_frames(VIDEO_FIXTURE, max_frames=2)
    paths = []
    for i, f in enumerate(frames):
        paths.append(os.path.join(work, f"frame{i}.png"))
        imwrite(paths[-1], f)
    out_dir = os.path.join(work, "overlays")
    lines = [json.loads(x) for x in cli_json([
        "detect", *paths, "--model", "googlenet_detectnet", "--weights",
        snapshot, "--overlay-dir", out_dir, "--device", "cuda"])]
    boxes = 0
    for path, frame, line in zip(paths, frames, lines):
        dets = [(d["box"], d["label"], d["confidence"])
                for d in line["detections"]]
        boxes += len(dets)
        png = os.path.join(out_dir, os.path.basename(path)[:-4] + "_det.png")
        if not np.array_equal(imread(png), draw_detections(frame, dets)):
            raise AssertionError(f"inputs: {png} is not draw_detections of "
                                 f"its frame and detections")
    if len(lines) != len(paths) or not boxes:
        raise AssertionError(f"inputs: cli detect --overlay-dir printed "
                             f"{lines}")
    manifest = os.path.join(work, "boxes.txt")
    with open(manifest, "w") as f:
        f.write("".join(f"{p} 40 30 120 90 1\n" for p in paths))
    prefix = os.path.join(work, "rec", "ds")
    os.makedirs(os.path.dirname(prefix))
    cli_json(["records", "--manifest", manifest, "--out", prefix])
    inspect_dir = os.path.join(work, "inspect")
    inspect = json.loads(cli_json([
        "train", "--recipe", "bounding_box", "--records", prefix,
        "--batch-size", "2", "--inspect-data", inspect_dir,
        "--snapshot-dir", os.path.join(work, "snap"), "--device",
        "cuda"])[-1])
    cfg = recipe("bounding_box")
    batch = next(iter(RecordTrainPipeline(prefix, cfg.grid, batch_size=2)))
    for i in range(2):
        dets = [([r[0], r[1], r[0] + r[2], r[1] + r[3]], int(l), 1.0)
                for r, l, v in zip(batch["rects"][i], batch["labels"][i],
                                   batch["valid"][i]) if v]
        png = os.path.join(inspect_dir, f"b0_{i:02d}.png")
        if not dets or not np.array_equal(
                imread(png), draw_detections(batch["image"][i], dets)):
            raise AssertionError(f"inputs: {png} is not draw_detections of "
                                 f"the records' first batch")
    if inspect != {"inspect_data": inspect_dir, "images": 2,
                   "with_seg": False}:
        raise AssertionError(f"inputs: train --inspect-data printed "
                             f"{inspect}")
    log("inputs", f"overlay: draw_detections of the seeded case (448x448, "
        f"10 boxes, 95 characters) as recorded from tpufcn's cv2 drawing; "
        f"{overlay_ms:.2f} ms an overlay on the host (median of "
        f"{OVERLAY_REPS}); cli detect --overlay-dir: {len(paths)} PNGs, "
        f"{boxes} boxes, each draw_detections of its frame; cli train "
        f"--records --inspect-data: {inspect}, its PNGs draw_detections of "
        f"the records' first batch; on {card}")
    return dict(overlay_ms=overlay_ms, reps=OVERLAY_REPS,
                detect_pngs=len(paths), detect_boxes=boxes,
                inspect=inspect)


def pool_probe(root: str, card: str) -> dict:
    """pool_streams and pool_throughput over the hard sources written as
    PNGs under ``root`` (run in a fresh process by phase_inputs)."""
    from torchfcn.data.manifest import read_mask_manifest
    work = os.path.join(root, "files")
    os.makedirs(work, exist_ok=True)
    manifest, backgrounds = manifest_files(root, work)
    samples = read_mask_manifest(manifest)
    return dict(streams=pool_streams(samples, backgrounds, work, card),
                throughput=pool_throughput(samples, backgrounds, card))


def pool_training(root: str, card: str) -> dict:
    """manifest_training through POOL_TRAIN_WORKERS workers, the four
    kernel wrappers as counters (run in a fresh process by phase_inputs;
    the CUDA context is made before the clock starts)."""
    from torchfcn.ops.cuda import build
    from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
    from torchfcn.ops.cuda.lrn import lrn_cuda
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda
    from torchfcn.ops.cuda.stem import stem_tail_cuda
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    counters = {"group_rects": group_rectangles_cuda, "lrn": lrn_cuda,
                "lrn_maxpool": lrn_maxpool_cuda, "stem_tail": stem_tail_cuda}
    return manifest_training(root, counters, card,
                             workers=POOL_TRAIN_WORKERS, phase="inputs")


def in_fresh_process(call: str, *args) -> dict:
    """``chip_smoke.<call>(*args)`` in a fresh Python process started with
    ``-c``.  A spawned worker pool's children import the parent's main
    script first: this script's (torch included) delayed their first batch
    by 11-15 s on an H100 host (PERF.md, section 6), where ``python -m
    torchfcn.cli``'s costs them the CLI module alone; under ``-c`` they
    import no main script.  Relays the process's log lines; returns the
    JSON of its last line."""
    code = ("import json, sys\n"
            "import chip_smoke\n"
            f"out = chip_smoke.{call}(*json.loads(sys.argv[1]))\n"
            "print(json.dumps(out), flush=True)\n")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(args)],
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO_ROOT),
                          timeout=600)
    lines = proc.stdout.splitlines()
    if proc.returncode or not lines:
        raise AssertionError(f"inputs: {call} in a fresh process exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    for line in lines[:-1]:
        print(line, flush=True)
    return json.loads(lines[-1])


def phase_inputs(rng, counters, card: str, serial_manifest: dict) -> dict:
    """The worker pool, e5m2 storage without store_stem2 and camera
    recordings on the card (the module docstring's phase 16); returns
    their readings.  ``serial_manifest`` is phase 15's train --manifest
    reading, printed beside the pool's.  The pools run in fresh processes
    (in_fresh_process), as they would under ``python -m torchfcn.cli``."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    seconds = {}
    root = tempfile.mkdtemp(prefix="torchfcn_inputs_")
    work = os.path.join(root, "files")
    os.makedirs(work)
    t = time.perf_counter()
    probe = in_fresh_process("pool_probe", root, card)
    seconds["pool_probe"] = time.perf_counter() - t
    t = time.perf_counter()
    train = in_fresh_process("pool_training", root, card)
    seconds["pool_train"] = time.perf_counter() - t
    log("inputs", f"train --manifest B={MANIFEST_BATCH} 224x224 through "
        f"{POOL_TRAIN_WORKERS} workers: {train['steps_s']:.3f} steps/s over "
        f"the command, idle {100 * train['idle_share']:.1f} %, "
        f"{train['loop_ms_step']:.1f} ms a step in the Trainer's loop, idle "
        f"{100 * train['loop_idle_share']:.1f} %; phase 15's --workers 0 in "
        f"this run {serial_manifest['steps_s']:.3f} steps/s, idle "
        f"{100 * serial_manifest['idle_share']:.1f} %, "
        f"{serial_manifest['loop_ms_step']:.1f} ms a step, idle "
        f"{100 * serial_manifest['loop_idle_share']:.1f} %; on {card}")
    t = time.perf_counter()
    stem2 = stem2_detector(rng, counters, card)
    seconds["stem2"] = time.perf_counter() - t
    t = time.perf_counter()
    video = video_inputs(counters, card, work)
    seconds["video"] = time.perf_counter() - t
    t = time.perf_counter()
    overlay = overlay_outputs(card, work, os.path.join(work, "firing"))
    seconds["overlay"] = time.perf_counter() - t
    shutil.rmtree(root)
    seconds["phase"] = time.perf_counter() - t_phase
    log("inputs", f"phase took {seconds['phase']:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items() if k != "phase"))
    return dict(pool=dict(train=train, **probe,
                          serial_train={k: serial_manifest[k] for k in (
                              "steps_s", "idle_share", "busy_ms", "wall_s",
                              "loop_ms_step", "loop_idle_share")}),
                stem2=stem2, video=video, overlay=overlay, seconds=seconds)


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
    stream = phase_stream(rng, counters, card)
    families, big = phase_families(rng, counters, card)
    rows["group_rects"].update(big)
    train = phase_train(rng, counters, card)
    data = phase_data(counters, card)
    gate = phase_gates(counters, card)
    mesh = phase_mesh(rng, counters, card)
    records = phase_records(counters, card)
    tools = phase_tools(counters, card)
    compositor = phase_compositor(counters, card)
    inputs = phase_inputs(rng, counters, card, compositor["manifest"])

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
                    stream_launches_per_dispatch={
                        graph: stream[graph]["launches_per_dispatch"][name]
                        for graph in ("flagship", "serving")},
                    train_launches_per_step=per_step[name] / (
                        TRAIN_WARMUP + TRAIN_STEPS),
                    composed_train_launches_per_step=composed_step[name],
                    validation_launches=data["validation"][
                        "group_rects_per_validation"]
                    if name == "group_rects" else 0,
                    gate_train_launches_per_step=gate["detection"][
                        "launches_per_train_step"][name],
                    gate_scoring_launches={
                        tag: n[name] for tag, n in
                        gate["detection"]["scoring_launches"].items()},
                    mesh_launches_per_rank=mesh_launches(mesh, name),
                    mesh_max_abs_err=mesh_plain_err(mesh, name),
                    records_train_launches=records["chain"][
                        "train_launches"][name],
                    records_eval_launches=records["chain"][
                        "eval_launches"][name],
                    voc_gate_scoring_launches=records["gate"][
                        "scoring_launches"][name],
                    host_gate_train_launches_per_step=compositor["gate"][
                        "launches_per_train_step"][name],
                    host_gate_scoring_launches={
                        tag: n[name] for tag, n in
                        compositor["gate"]["scoring_launches"].items()},
                    stem2_launches=inputs["stem2"]["launches"][name],
                    video_launches_per_dispatch=inputs["video"]["replay"][
                        "launches_per_dispatch"][name],
                    **rows[name]) for name in counters]
    rows_voc = records["gate"]["against_plain"]
    next(k for k in kernels if k["name"] == "group_rects")["voc_gate"] = {
        k: rows_voc[k] for k in (
        "shape", "valid_candidates", "max_abs_err", "ms", "call_ms",
        "plain_ms", "bound_ms", "bound_by")}
    halo = mesh["stem_tail_halo"]
    kernels.append(dict(
        name="stem_tail_halo", route="cuda", source=meta["stem_tail"][0],
        replaces=meta["stem_tail"][1],
        launches=mesh_launches(mesh, "stem_tail")["space_e5m2"][0],
        mesh_launches_per_rank=mesh_launches(mesh, "stem_tail"), **halo))
    print(json.dumps({"card": card, "stream": stream}), flush=True)
    print(json.dumps({"card": card, "families": families}), flush=True)
    print(json.dumps({"card": card, "train": train}), flush=True)
    print(json.dumps({"card": card, "data": data}), flush=True)
    print(json.dumps({"card": card, "gates": gate}), flush=True)
    print(json.dumps({"card": card, "mesh": mesh}), flush=True)
    print(json.dumps({"card": card, "records": records}), flush=True)
    print(json.dumps({"card": card, "tools": tools}), flush=True)
    print(json.dumps({"card": card, "compositor": compositor}), flush=True)
    print(json.dumps({"card": card, "inputs": inputs}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
