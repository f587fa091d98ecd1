"""Device-time breakdown of the serving pipeline or a train step, by
``torch.profiler``: the one profiling path of the port, which the CLI's
``profile`` subcommand runs.  From the repository root:

    python -m torchfcn.cli profile [--model NAME ...] [--train] [--json]
    python -m torchfcn.serve.profile [...]     # the same subcommand

``--model`` takes any registered model name and may repeat; by default
``googlenet_detectnet`` (bf16) and ``googlenet_detectnet_serving`` (e5m2
storage, bf16 compute).  A detection model runs through the Detector in
bf16 with K = ``--max-candidates`` and the heads biased by ``bias_heads``
so that NMS gets real clusters, a segmentation model through the
Segmenter; ``--train`` profiles a train step (forward, backward, Adam) on a
synthetic batch instead.  Each gets ``--batch`` seeded uint8 frames of its
net's size sent from host memory: 3 warm-up calls, then ``--iters`` calls
under the profiler.  On the card the entries are the device self time of
every kernel and copy (one stream, so nothing overlaps, and their sum is
the device-busy time); on the CPU (``--device cpu``), the self time of
every operator.
"""

from __future__ import annotations

import sys
import tempfile
import time

import numpy as np
import torch

SEED, WARMUP = 0, 3
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


def serving_path(model: str, frames: np.ndarray, device: str = "cuda",
                 max_candidates: int = 256):
    """One bf16 serving call of ``model`` on ``frames``, as a callable that
    returns once the result is on the host."""
    from torchfcn.models import get_spec
    from torchfcn.serve.detector import Detector
    from torchfcn.serve.segment import Segmenter
    if "coverage" in get_spec(model).heads:
        det = Detector(model, max_candidates=max_candidates,
                       dtype=torch.bfloat16, rng_seed=SEED, device=device)
        bias_heads(det)
        return lambda: det(frames).boxes.cpu()
    seg = Segmenter(model, dtype=torch.bfloat16, rng_seed=SEED,
                    device=device)
    return lambda: seg(frames).cpu()


def train_path(model: str, frames: np.ndarray, device: str = "cuda"):
    """One train step (forward, backward, Adam) of ``model`` on a synthetic
    batch of ``frames``, one box each, as a callable that returns the
    loss."""
    from torchfcn.core.config import DataConfig, TrainConfig
    from torchfcn.models import get_spec
    from torchfcn.train.trainer import Trainer

    spec = get_spec(model)
    b, h, w = frames.shape[:3]
    cfg = TrainConfig(
        grid=spec.grid, model=model, data=DataConfig(batch_size=b),
        snapshot_every=0, log_every=10 ** 9,
        snapshot_dir=tempfile.mkdtemp(prefix="torchfcn_profile_snap_"))
    with_seg = "seg" in spec.heads
    trainer = Trainer(cfg, with_seg=with_seg, log_sink=lambda s: None,
                      device=device)
    holder = [trainer.init_state()]
    c = spec.grid.num_classes
    lo = 1 if spec.background_channel is not None else 0
    batch = {
        "image": frames,
        "rects": np.tile(np.array([8, 8, h // 2, w // 2], np.float32),
                         (b, 4, 1)),
        "labels": np.full((b, 4), max(c - 1 - lo, 0), np.int32),
        "valid": np.tile(np.array([True, False, False, False]), (b, 1)),
    }
    if with_seg:
        batch["seg"] = np.zeros((b, h, w), np.int32)
    put = trainer.put(batch)

    def run():
        holder[0], metrics = trainer.step_fn(holder[0], put)
        return float(metrics["loss_total"])
    return run


def profile_path(model: str, device: str = "cuda", batch: int = 8,
                 iters: int = 10, train: bool = False,
                 max_candidates: int = 256, logdir=None) -> dict:
    """Profile ``iters`` calls of ``model``'s serving pipeline (or, with
    ``train``, its train step) after ``WARMUP`` calls outside the trace;
    writes the Chrome trace to ``logdir`` (a new temporary directory when
    None) and returns the breakdown: ``total_device_us`` over the calls
    (device-busy time on the card, operator self time on the CPU),
    ``wall_ms`` per call, and ``ops``, every entry sorted by time."""
    from torchfcn.models import get_spec
    from torchfcn.utils.profiling import aggregate_device_trace, device_trace

    grid = get_spec(model).grid
    frames = np.random.default_rng(SEED).integers(
        0, 256, (batch, grid.im_height, grid.im_width, 3), dtype=np.uint8)
    run = (train_path(model, frames, device) if train
           else serving_path(model, frames, device, max_candidates))
    cuda = device != "cpu"
    for _ in range(WARMUP):
        run()
    if cuda:
        torch.cuda.synchronize()
    logdir = logdir or tempfile.mkdtemp(prefix="torchfcn_profile_")
    with device_trace(logdir, cuda=cuda) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = aggregate_device_trace(prof, device="cuda" if cuda else "cpu")
    return dict(model=model, mode="train" if train else "serve",
                batch=batch, device=device, iters=iters,
                total_device_us=sum(o["dur_us"] for o in ops),
                wall_ms=wall * 1e3 / iters, logdir=logdir, ops=ops)


if __name__ == "__main__":
    from torchfcn.cli import main
    sys.exit(main(["profile", *sys.argv[1:]]))
