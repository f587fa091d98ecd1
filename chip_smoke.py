#!/usr/bin/env python3
"""Smoke run of the torchfcn serving path on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: compile ``torchfcn/csrc`` with nvcc for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the serving path's shapes, with both times (CUDA events, median of
   25 runs after 3 warm-up runs).  groupRectangles must match exactly; LRN
   within 1 bf16 ulp in bf16 and rtol 1e-5 in float32;
4. parity: the float32 forward (TF32 off) of 2 frames on the card and on
   the CPU with the same weights, heads within atol 1e-3; then decode + NMS
   of the card's heads on both devices, DetectionResult exactly equal;
5. main path: ``Detector("googlenet_detectnet", max_candidates=256)`` in
   bf16 on 8 seeded 448x448 frames.  Every kernel must have launched in
   that run; the detections must equal decode + NMS of the same heads on
   the CPU.  Prints detections, frames/s and latency per batch, then
   checks and times the groupRectangles kernel again on that run's own
   candidates, whose numbers go into the JSON line (its time depends on
   the data: it sweeps once per step of a cluster's diameter).

Then one JSON line of per-kernel numbers, and last the result line
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.  Weights are the seeded Caffe "xavier" init; the coverage and bbox
head biases are set so that cells fire with boxes tall enough to survive
the NMS height filter.
"""

from __future__ import annotations

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


def check_group_rects(rects, valid, what: str) -> dict:
    """groupRectangles kernel against its plain version on the card: exact
    in every field; returns its numbers and both times."""
    from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
    from torchfcn.ops.group_rects import group_rectangles
    got = group_rectangles_cuda(rects, valid)
    want = group_rectangles(rects, valid)
    torch.cuda.synchronize()
    for field in ("rects", "weights", "valid"):
        a, b = getattr(got, field), getattr(want, field)
        if not torch.equal(a, b):
            raise AssertionError(
                f"group_rects on {what}: {field} differs in "
                f"{int((a != b).sum())} entries")
    row = dict(max_abs_err=float((got.rects - want.rects).abs().max()),
               ms=median_ms(lambda: group_rectangles_cuda(rects, valid)),
               plain_ms=median_ms(lambda: group_rectangles(rects, valid)))
    log("kernels", f"group_rects {tuple(rects.shape)} on {what}: exact "
        f"({int(got.valid.sum())} clusters kept), kernel {row['ms']:.4f} "
        f"ms, plain {row['plain_ms']:.4f} ms")
    return row


def phase_kernels(rng) -> dict:
    """LRN kernels (and groupRectangles on synthetic candidates); returns
    the LRN kernels' numbers for the JSON line."""
    from torchfcn.ops.caffe_layers import lrn_across_channels, max_pool_caffe
    from torchfcn.ops.cuda.lrn import lrn_cuda
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda

    dev = torch.device("cuda")
    rows = {}
    check_group_rects(*nms_inputs(rng, dev), "clustered + random boxes")

    cases = (
        ("lrn", (BATCH, 112, 112, 64), lrn_cuda, lrn_across_channels),
        ("lrn_maxpool", (BATCH, 112, 112, 192), lrn_maxpool_cuda,
         lambda x: max_pool_caffe(lrn_across_channels(x), 3, 2)),
    )
    for name, shape, kernel, plain in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 * 60).to(dev, dtype)
            got, want = kernel(x), plain(x)
            torch.cuda.synchronize()
            err = check_lrn_outputs(got, want, dtype, f"{name} {dtype}")
            ms = median_ms(lambda: kernel(x))
            plain_ms = median_ms(lambda: plain(x))
            log("kernels", f"{name} {shape} {dtype}: max|err| {err:.3g}, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        # the serving path runs bf16: its numbers go into the JSON line
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rows


def bias_heads(det) -> None:
    """Coverage bias 1 (as tests/test_detector_parity.py does) so many
    cells fire, and bbox bias (-24, -24, 40, 40) per class so the decoded
    boxes are 64 px tall and clear the NMS height filter."""
    with torch.no_grad():
        det.model.cvg.bias.fill_(1.0)
        det.model.bbox.bias.copy_(torch.tensor(
            [-24.0, -24.0, 40.0, 40.0]).repeat(det.grid.num_classes))


def assert_same_result(a, b, what: str) -> None:
    for field in ("boxes", "confidence", "valid"):
        x, y = getattr(a, field).cpu(), getattr(b, field).cpu()
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: DetectionResult.{field} differs "
                                 f"in {int((x != y).sum())} entries")


def phase_parity(rng) -> None:
    from torchfcn.serve.detector import Detector
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


def phase_main_path(rng, counters, card: str):
    """Returns the launch counts of one main-path run and the
    groupRectangles kernel's numbers on that run's candidates.  ``card`` is
    nvidia-smi's name and power limit, printed beside the rate."""
    from torchfcn.ops.grid_codec import decode_gridboxes
    from torchfcn.serve.detector import Detector, select_candidates
    det = Detector("googlenet_detectnet", max_candidates=K,
                   dtype=torch.bfloat16, rng_seed=SEED, device="cuda")
    bias_heads(det)
    frames = rng.integers(0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)

    for fn in counters.values():
        fn.launches = 0
    res = det(frames)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")

    if res.boxes.shape != (BATCH, 4, K, 4) or res.boxes.dtype != torch.int32:
        raise AssertionError(f"main path: boxes {tuple(res.boxes.shape)} "
                             f"{res.boxes.dtype}")
    if not bool(torch.isfinite(res.confidence).all()):
        raise AssertionError("main path: non-finite confidence")
    with torch.inference_mode():
        heads = det._forward(torch.as_tensor(frames, device="cuda"))
        cpu = Detector("googlenet_detectnet", max_candidates=K,
                       dtype=torch.bfloat16, rng_seed=SEED, device="cpu")
        want = cpu._decode_nms(*(h.cpu() for h in heads), (NET, NET))
    assert_same_result(res, want, "main path vs decode+NMS on the cpu")
    # the kernel on the main path's own candidates: its JSON numbers
    with torch.inference_mode():
        boxes, cvg, valid = decode_gridboxes(
            *heads, det.grid, det.config.detection_threshold)
        cand, cand_valid = select_candidates(cvg, boxes, valid, K)
    row = check_group_rects(cand.reshape(-1, K, 4).contiguous(),
                            cand_valid.reshape(-1, K).contiguous(),
                            "the main path's candidates")

    times = []
    for _ in range(WARMUP + REPS):
        t0 = time.perf_counter()
        det(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    latency = statistics.median(times[WARMUP:])
    log("main", f"Detector googlenet_detectnet bf16 B={BATCH} {NET}x{NET} "
        f"K={K}: {int(res.valid.sum())} detections; launches {launches}; "
        f"{BATCH / latency:.1f} frames/s, {latency * 1e3:.3f} ms per batch "
        f"(median of {REPS}, host clock, uint8 frames from host memory) "
        f"on {card}")
    return launches, row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from torchfcn.ops.cuda import build
    from torchfcn.ops.cuda.group_rects import group_rectangles_cuda
    from torchfcn.ops.cuda.lrn import lrn_cuda
    from torchfcn.ops.cuda.lrn_pool import lrn_maxpool_cuda

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
    launches, rows["group_rects"] = phase_main_path(rng, counters, card)

    meta = {
        "group_rects": ("torchfcn/csrc/group_rects.cu",
                        "tpufcn/ops/pallas/group_rects.py:166"),
        "lrn": ("torchfcn/csrc/lrn.cu", "tpufcn/ops/pallas/lrn.py:38"),
        "lrn_maxpool": ("torchfcn/csrc/lrn.cu",
                        "tpufcn/ops/pallas/lrn_pool.py:94"),
    }
    kernels = [dict(name=name, route="cuda", source=meta[name][0],
                    replaces=meta[name][1], launches=launches[name],
                    **rows[name]) for name in counters]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
