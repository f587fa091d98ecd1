"""Device-time breakdown of the two serving paths on one NVIDIA GPU, by
``torch.profiler``.  Run from the repository root:

    python -m torchfcn.serve.profile

For ``googlenet_detectnet`` (bf16) and ``googlenet_detectnet_serving``
(e5m2 storage, bf16 compute), each on 8 seeded 448x448 uint8 frames sent
from host memory, with the coverage and bbox head biases set by
``bias_heads`` so that NMS gets real clusters: 3 warm-up batches, then 10
batches under the profiler.  Prints, per path, the device-busy time per
batch (the sum of the device self time of every kernel and copy; one
stream, so nothing overlaps), the wall time per batch of the profiled loop,
and the entries with the most device time per batch, then one JSON line
with the same numbers.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

BATCH, NET, K, SEED, WARMUP, BATCHES, TOP = 8, 448, 256, 0, 3, 10, 14


def bias_heads(det) -> None:
    """Coverage bias 1 (as tests/test_detector_parity.py does) so many
    cells fire, and bbox bias (-24, -24, 40, 40) per class so the decoded
    boxes are 64 px tall and clear the NMS height filter."""
    with torch.no_grad():
        det.model.cvg.bias.fill_(1.0)
        det.model.bbox.bias.copy_(torch.tensor(
            [-24.0, -24.0, 40.0, 40.0]).repeat(det.grid.num_classes))


def device_rows(prof) -> list:
    """(name, device self time in µs, count) of every kernel and copy that
    ``prof`` (a finished ``torch.profiler.profile``) saw on the device."""
    rows = []
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us > 0 and event.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((event.key, float(us), event.count))
    return rows


def profile_path(model: str) -> dict:
    """Profile BATCHES batches of ``model``; returns its breakdown."""
    from torchfcn.serve.detector import Detector
    det = Detector(model, max_candidates=K, dtype=torch.bfloat16,
                   rng_seed=SEED, device="cuda")
    bias_heads(det)
    frames = np.random.default_rng(SEED).integers(
        0, 256, (BATCH, NET, NET, 3), dtype=np.uint8)
    for _ in range(WARMUP):
        det(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BATCHES):
            det(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(name, us / 1e3 / BATCHES, count / BATCHES)
            for name, us, count in device_rows(prof)]
    rows.sort(key=lambda r: -r[1])
    return dict(model=model, batches=BATCHES,
                busy_ms=sum(r[1] for r in rows),
                wall_ms=wall * 1e3 / BATCHES,
                top=[dict(name=n[:90], ms=ms, launches=c)
                     for n, ms, c in rows[:TOP]])


def main() -> int:
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    results = []
    for model in ("googlenet_detectnet", "googlenet_detectnet_serving"):
        r = profile_path(model)
        results.append(r)
        print(f"{model} B={BATCH} {NET}x{NET} on {card}: device busy "
              f"{r['busy_ms']:.3f} ms of {r['wall_ms']:.3f} ms wall per "
              f"batch ({100 * (1 - r['busy_ms'] / r['wall_ms']):.0f} % idle)")
        for row in r["top"]:
            print(f"  {row['ms']:8.4f} ms  x{row['launches']:5.1f}  "
                  f"{row['name']}")
    print(json.dumps({"card": card, "paths": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
