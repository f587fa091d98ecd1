"""A pool of host processes that compose training scenes
(``tpufcn/data/parallel.py``).

``CompositeTrainPipeline`` composes each scene in numpy, 45-70 ms at 224-448
pixels on the card's host, one scene after the other, while the card waits.
``ParallelCompositePipeline`` fans that work out to ``workers`` processes,
each owning its own ``CompositeTrainPipeline`` seeded ``seed + 1000 * w``,
which push finished batches into one bounded queue.

Workers are started with ``spawn``: the training process holds a CUDA
context, which a forked child must not inherit.  Nothing a worker imports
(``torchfcn.data``) touches ``torch.cuda``, and everything it is given
(samples, grid, config, background paths) pickles.  A spawned child first
imports the parent's main script (not a ``python -c`` one), so that
script's top-level imports delay every worker's start: ``python -m
torchfcn.cli`` costs them the CLI module alone, a script that imports
torch at its top costs them torch.  A worker's exception
reaches the consumer as a ``RuntimeError`` with its traceback, and a pool
whose workers have all exited raises instead of blocking.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from torchfcn.core.config import DataConfig, GridConfig
from torchfcn.data.manifest import MaskSample

# seconds a consumer waits on the queue before it looks at the workers
POLL_S = 5.0
# seconds ``close`` gives each worker to stop before it terminates it
JOIN_S = 2.0


def _worker(samples, grid, data_cfg, backgrounds, box_capacity, seed,
            batch_size, q, stop):
    """Build batches until ``stop`` is set (in a child process; the import
    stays inside, so that the parent's import of this module costs the
    child nothing)."""
    from torchfcn.data.pipeline import CompositeTrainPipeline
    try:
        pipe = CompositeTrainPipeline(samples, grid, data_cfg,
                                      backgrounds=backgrounds,
                                      box_capacity=box_capacity, seed=seed)
        while not stop.is_set():
            q.put(pipe.batch(batch_size))
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    except Exception:           # noqa: BLE001 -- relayed to the consumer
        import traceback
        try:
            q.put({"__worker_error__": traceback.format_exc()})
        except Exception:       # noqa: BLE001 -- the consumer is gone
            pass


class ParallelCompositePipeline:
    """Process-pool batch source with the yield contract of
    :class:`~torchfcn.data.pipeline.CompositeTrainPipeline` (a dict of
    image, rects, labels, valid, seg).

    Batches arrive in the order the workers finish them; worker ``w``'s
    batches are those of ``CompositeTrainPipeline(..., seed=seed + 1000 *
    w)``, in its order, so the union holds no scene twice.
    """

    def __init__(self,
                 samples: Sequence[MaskSample],
                 grid: GridConfig,
                 data_cfg: Optional[DataConfig] = None,
                 backgrounds: Optional[Sequence[str]] = None,
                 box_capacity: int = 8,
                 workers: int = 4,
                 depth: int = 8,
                 seed: int = 0,
                 start_method: str = "spawn"):
        self.cfg = data_cfg or DataConfig()
        ctx = mp.get_context(start_method)
        self._queue = ctx.Queue(maxsize=depth)
        self._stop = ctx.Event()
        self._procs = []
        for w in range(max(workers, 1)):
            p = ctx.Process(
                target=_worker,
                args=(list(samples), grid, self.cfg, list(backgrounds or []),
                      box_capacity, seed + 1000 * w, self.cfg.batch_size,
                      self._queue, self._stop),
                daemon=True)
            p.start()
            self._procs.append(p)

    def _get(self) -> Dict[str, np.ndarray]:
        """The next batch; raises when a worker failed, or when every
        worker has exited (with ``spawn``, a parent whose ``__main__`` a
        child cannot import, such as a script on stdin)."""
        while True:
            try:
                item = self._queue.get(timeout=POLL_S)
            except queue.Empty:
                if not any(p.is_alive() for p in self._procs):
                    raise RuntimeError(
                        "all scene-builder workers exited; with "
                        "start_method='spawn' the parent __main__ must be "
                        "importable (a real script or pytest, not stdin)")
                continue
            if isinstance(item, dict) and "__worker_error__" in item:
                raise RuntimeError("scene-builder worker failed:\n"
                                   + item["__worker_error__"])
            return item

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self._get()

    def batch(self, batch_size: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        """One batch (its size is the config's; the argument keeps
        CompositeTrainPipeline's interface)."""
        return self._get()

    def throughput(self, n_batches: int = 8) -> float:
        """Composed scenes a second arriving at the consumer, over
        ``n_batches`` batches after a first one."""
        self._get()
        t0 = time.perf_counter()
        for _ in range(n_batches):
            self._get()
        return n_batches * self.cfg.batch_size / (time.perf_counter() - t0)

    def close(self):
        """Stop the workers and reap them: they get JOIN_S seconds in all
        to finish their batch and exit, then the rest are terminated."""
        self._stop.set()
        # drain meanwhile: a worker blocked on a full queue, or flushing its
        # last batch into the pipe, exits only once it is read
        deadline = time.monotonic() + JOIN_S
        while any(p.is_alive() for p in self._procs) \
                and time.monotonic() < deadline:
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join()
        self._queue.close()
        self._queue.cancel_join_thread()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
