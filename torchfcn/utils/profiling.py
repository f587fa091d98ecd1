"""Tracing and profiling hooks of the port (``tpufcn/utils/profiling.py``).

* :func:`device_trace`: a context manager around ``torch.profiler`` that
  yields the profile and, given a directory, writes its Chrome trace there;
* :func:`aggregate_device_trace`: the time of every kernel and copy the
  profile saw on the card (``torchfcn.serve.profile.device_rows``), or, for
  a run on the CPU, the self time of every operator on the CPU;
* :class:`StageTimer`: named per-stage wall timers with p50/p95/mean
  summaries (a copy of the JAX package's).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None, cuda: bool = True):
    """Profile the body with ``torch.profiler`` (the CPU, and the card
    where ``cuda`` is set); yields the profile, whose rows are ready once
    the scope has closed.  With ``logdir``, writes ``trace.json`` (Chrome
    trace format) there."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def aggregate_device_trace(prof, top: int = 0, device: str = "cuda"):
    """Per-entry time of a finished ``device_trace`` profile, as a list of
    ``{"name", "dur_us", "count"}`` sorted by descending total time.

    ``device="cuda"``: the device self time of every kernel and copy on the
    card; ``"cpu"``: the self time on the CPU of every operator (the plain
    versions run there), ``record_function`` ranges left out.  ``top``
    truncates the list when positive."""
    if device == "cuda":
        from torchfcn.serve.profile import device_rows
        rows = device_rows(prof)
    else:
        import torch
        rows = [(e.key, float(e.self_cpu_time_total), e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.self_cpu_time_total > 0
                and not getattr(e, "is_user_annotation", False)]
    out = [{"name": name, "dur_us": us, "count": count}
           for name, us, count in sorted(rows, key=lambda r: -r[1])]
    return out[:top] if top else out


class StageTimer:
    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        import numpy as np
        out = {}
        for name, vals in self._samples.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "total_s": float(arr.sum()),
            }
        return out

    def report(self, sink=print) -> None:
        for name, s in sorted(self.summary().items()):
            sink(f"{name}: n={s['count']} mean={s['mean_ms']:.2f}ms "
                 f"p50={s['p50_ms']:.2f}ms p95={s['p95_ms']:.2f}ms")
