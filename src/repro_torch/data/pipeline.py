"""Input pipeline with CBP-managed prefetch (copy of
:mod:`repro.data.pipeline`, numpy and threads).

``PrefetchPipeline`` wraps any batch iterator with a background prefetch
queue whose DEPTH is the paper's prefetch knob in this substrate: depth 0
disables prefetching (synchronous fetch), larger depths hide host latency
at the cost of host memory ("cache") and host->device bandwidth.  The CBP
prefetch controller A/B samples step throughput with different depths and
throttles exactly like Algorithm 2; the queue's measured wait times feed
the bandwidth controller.

The pipeline is resumable: ``state()`` returns the batch counter, which is
persisted in checkpoints and restored on restart (fault tolerance).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class SyntheticTokens:
    """Deterministic synthetic LM batches (seeded; resumable by index)."""

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 start_index: int = 0):
        self.batch = batch
        self.seq = seq
        self.vocab = vocab
        self.seed = seed
        self.index = start_index

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.index))
        toks = rng.integers(
            0, self.vocab, size=(self.batch, self.seq), dtype=np.int32)
        self.index += 1
        return {"tokens": toks, "labels": toks}

    def state(self) -> Dict:
        return {"index": self.index, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        self.index = int(state["index"])
        self.seed = int(state["seed"])


class PrefetchPipeline:
    """Background prefetcher with a dynamic depth knob.

    Metrics exposed for the CBP controllers:
      * ``mean_wait_ms``   — time the consumer blocked on the queue
        (the "queuing delay" signal for the bandwidth controller),
      * ``throughput``     — batches/sec delivered (the IPC analogue for
        the prefetch controller's A/B sampling).
    """

    def __init__(self, source, depth: int = 2,
                 fetch_cost_s: float = 0.0):
        self.source = source
        self._fetch_cost = fetch_cost_s
        self._depth = max(int(depth), 0)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(self._depth, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._waits = []
        self._deliveries = 0
        self._t_start = time.monotonic()
        if self._depth > 0:
            self._start()

    # ------------------------------------------------------------- #

    def _start(self):
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = next(self.source)
            if self._fetch_cost:
                time.sleep(self._fetch_cost)
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def set_depth(self, depth: int) -> None:
        """Prefetch throttle: 0 = off.  Restarts the worker if needed."""
        depth = max(int(depth), 0)
        if depth == self._depth:
            return
        self.stop()
        self._stop = threading.Event()
        self._depth = depth
        self._queue = queue.Queue(maxsize=max(depth, 1))
        if depth > 0:
            self._start()

    @property
    def depth(self) -> int:
        return self._depth

    def __next__(self) -> Dict[str, np.ndarray]:
        t0 = time.monotonic()
        if self._depth == 0:
            batch = next(self.source)
            if self._fetch_cost:
                time.sleep(self._fetch_cost)
        else:
            batch = self._queue.get()
        self._waits.append(time.monotonic() - t0)
        self._deliveries += 1
        return batch

    def __iter__(self):
        return self

    # ---------------- CBP metric surface ---------------- #

    def mean_wait_ms(self, reset: bool = True) -> float:
        if not self._waits:
            return 0.0
        w = 1000.0 * float(np.mean(self._waits))
        if reset:
            self._waits = []
        return w

    def throughput(self, reset: bool = True) -> float:
        dt = time.monotonic() - self._t_start
        tp = self._deliveries / max(dt, 1e-9)
        if reset:
            self._deliveries = 0
            self._t_start = time.monotonic()
        return tp

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # drain so the worker unblocks
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None
