"""torchfcn's batch sources (``torchfcn/data/pipeline.py``) and the port's
import boundary.

* ``DeviceBatchCache`` puts its N batches once and yields them in turn,
  forever, without copying batches that are already on the device; the
  Trainer's ``put`` drops "seg" unless it trains the seg head;
* ``prefetch`` raises the source's error to the consumer, and its worker
  stops when the consumer does;
* ``pad_boxes`` equals tpufcn's;
* no module of the port and not ``chip_smoke.py`` imports JAX, tpufcn or
  cv2 (the card's host has none of them).
"""

import ast
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from tpufcn.data.pipeline import pad_boxes as jax_pad_boxes
from torchfcn.core.config import GridConfig, TrainConfig
from torchfcn.data.pipeline import DeviceBatchCache, pad_boxes, prefetch
from torchfcn.train.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _source(n=None):
    i = 0
    while n is None or i < n:
        yield {"image": torch.full((2, 8, 8, 3), i, dtype=torch.uint8),
               "seg": torch.zeros((2, 8, 8), dtype=torch.int32)}
        i += 1


def test_cache_puts_once_and_cycles():
    calls = []

    def put(b):
        calls.append(b)
        return b

    src = _source()
    cache = DeviceBatchCache(put, src, 3)
    assert len(calls) == 3
    it = iter(cache)
    got = [int(next(it)["image"][0, 0, 0, 0]) for _ in range(7)]
    assert got == [0, 1, 2, 0, 1, 2, 0]
    assert len(calls) == 3
    assert int(next(src)["image"][0, 0, 0, 0]) == 3     # drew only 3
    with pytest.raises(ValueError, match="at least 1"):
        DeviceBatchCache(put, src, 0)


def test_cache_through_trainer_put_keeps_device_tensors():
    trainer = Trainer(TrainConfig(grid=GridConfig(8, 8, 8, 1)),
                      device="cpu", log_sink=lambda s: None)
    src = _source()
    first = next(_source())
    cache = DeviceBatchCache(trainer.put, src, 2)
    b = next(iter(cache))
    assert list(b) == ["image"]                 # "seg" dropped
    assert torch.equal(b["image"], first["image"])
    # a batch already on the device is the same tensor after put
    again = trainer.put(b)
    assert again["image"] is b["image"]
    seg_trainer = Trainer(TrainConfig(grid=GridConfig(8, 8, 8, 1)),
                          with_seg=True, device="cpu",
                          log_sink=lambda s: None)
    assert sorted(seg_trainer.put(first)) == ["image", "seg"]


def test_prefetch_propagates_errors():
    def bad():
        yield 1
        raise RuntimeError("source broke")

    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="source broke"):
        next(it)
    assert list(prefetch(iter(range(5)), transform=lambda x: x * 2)) == \
        [0, 2, 4, 6, 8]


def test_prefetch_worker_stops_with_the_consumer():
    produced = []
    before = threading.active_count()

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()                                   # the consumer stops
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    n = len(produced)
    time.sleep(0.5)
    assert len(produced) == n                    # no more batches built


@pytest.mark.parametrize("m,cap", [(0, 4), (3, 4), (6, 4)])
def test_pad_boxes_equals_jax(m, cap):
    rng = np.random.default_rng(m)
    rects = rng.uniform(0, 50, (m, 4))
    labels = rng.integers(0, 5, m)
    for got, want in zip(pad_boxes(rects, labels, cap),
                         jax_pad_boxes(rects, labels, cap)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_tpufcn_or_cv2():
    files = sorted((ROOT / "torchfcn").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                     "tpufcn", "cv2")]
    assert not bad, bad
