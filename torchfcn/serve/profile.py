"""Device-time breakdown of serving paths on one NVIDIA GPU, by
``torch.profiler``.  Run from the repository root:

    python -m torchfcn.serve.profile [--model NAME ...]

``--model`` takes any registered model name and may repeat; by default
``googlenet_detectnet`` (bf16) and ``googlenet_detectnet_serving`` (e5m2
storage, bf16 compute).  A detection model runs through the Detector with
K = 256 and the heads biased by ``bias_heads`` so that NMS gets real
clusters, a segmentation model through the Segmenter.  Each gets 8 seeded
uint8 frames of its net's size sent from host memory: 3 warm-up batches,
then 10 batches under the profiler.  Prints, per model, the device-busy
time per batch (the sum of the device self time of every kernel and copy;
one stream, so nothing overlaps), the wall time per batch of the profiled
loop, and the entries with the most device time per batch, then one JSON
line with the same numbers.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

BATCH, K, SEED, WARMUP, BATCHES, TOP = 8, 256, 0, 3, 10, 14
DEFAULT_MODELS = ("googlenet_detectnet", "googlenet_detectnet_serving")


def bias_heads(det) -> None:
    """Bias the heads of ``det.model`` so that cells fire with boxes tall
    enough for the NMS height filter, and neighbouring cells cluster:
    coverage bias 1 (as tests/test_detector_parity.py does), bbox bias
    (-24, -24, 40, 40) per class.  FCN-8s has no coverage conv: its
    coverage is the softmax of ``fuse3``, so foreground class 1 gets a
    ``score_pool3`` bias of 4 (softmax about 0.84), and the bbox bias goes
    on ``score_conv5_bbox``, before the k8 upsample."""
    model = det.model
    box = torch.tensor([-24.0, -24.0, 40.0, 40.0]).repeat(det.grid.num_classes)
    with torch.no_grad():
        if hasattr(model, "score_pool3"):
            model.score_pool3.bias[1] = 4.0
            model.score_conv5_bbox.bias.copy_(box)
        else:
            model.cvg.bias.fill_(1.0)
            model.bbox.bias.copy_(box)


def device_rows(prof) -> list:
    """(name, device self time in µs, count) of every kernel and copy that
    ``prof`` (a finished ``torch.profiler.profile``) saw on the device.
    A ``record_function`` range (such as ``Optimizer.step``) also shows on
    the device, spanning kernels counted already: it is left out."""
    rows = []
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us > 0 and event.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(event, "is_user_annotation", False):
            rows.append((event.key, float(us), event.count))
    return rows


def range_device_us(prof, prefix: str) -> float:
    """Device time in µs of the kernels and copies launched inside the
    ``record_function`` ranges of ``prof`` whose names start with
    ``prefix``, however deep below the range they were launched."""
    total = 0.0
    for event in prof.key_averages():
        if event.key.startswith(prefix) \
                and event.device_type == torch.autograd.DeviceType.CPU:
            us = getattr(event, "device_time_total", None)
            if us is None:
                us = getattr(event, "cuda_time_total", 0.0)
            total += float(us)
    return total


def serving_path(model: str):
    """The serving callable of ``model`` on the card, with its frame size."""
    from torchfcn.models import get_spec
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.segment import Segmenter
    spec = get_spec(model)
    if "coverage" in spec.heads:
        run = Detector(model, max_candidates=K, dtype=torch.bfloat16,
                       rng_seed=SEED, device="cuda")
        bias_heads(run)
    else:
        run = Segmenter(model, dtype=torch.bfloat16, rng_seed=SEED,
                        device="cuda")
    return run, spec.grid.im_height


def profile_path(model: str) -> dict:
    """Profile BATCHES batches of ``model``; returns its breakdown."""
    run, net = serving_path(model)
    frames = np.random.default_rng(SEED).integers(
        0, 256, (BATCH, net, net, 3), dtype=np.uint8)
    for _ in range(WARMUP):
        run(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BATCHES):
            run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(name, us / 1e3 / BATCHES, count / BATCHES)
            for name, us, count in device_rows(prof)]
    rows.sort(key=lambda r: -r[1])
    return dict(model=model, batch=BATCH, size=net, batches=BATCHES,
                busy_ms=sum(r[1] for r in rows),
                wall_ms=wall * 1e3 / BATCHES,
                top=[dict(name=n[:90], ms=ms, launches=c)
                     for n, ms, c in rows[:TOP]])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", action="append",
                        help="registered model name (repeatable)")
    models = parser.parse_args(argv).model or DEFAULT_MODELS
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    results = []
    for model in models:
        r = profile_path(model)
        results.append(r)
        print(f"{model} B={BATCH} {r['size']}x{r['size']} on {card}: device "
              f"busy {r['busy_ms']:.3f} ms of {r['wall_ms']:.3f} ms wall per "
              f"batch ({100 * (1 - r['busy_ms'] / r['wall_ms']):.0f} % idle)")
        for row in r["top"]:
            print(f"  {row['ms']:8.4f} ms  x{row['launches']:5.1f}  "
                  f"{row['name']}")
    print(json.dumps({"card": card, "paths": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
