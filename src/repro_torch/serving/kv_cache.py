"""Paged KV-cache pool with CBP cache partitioning (copy of
:mod:`repro.serving.kv_cache`).

The HBM KV-page pool is the serving analogue of the paper's shared LLC:
concurrent request streams (tenants) contend for pages; prefix/context
reuse means a stream's hit rate is a concave function of its page
allocation — exactly a miss-ratio curve.  Each stream owns a
:class:`StackDistanceMonitor` (the software ATD), and the pool reallocates
partitions with UCP/Lookahead every reconfiguration interval, with the
same ``min_units`` floor and counter halving as the paper's cache
controller.

Pages within a stream's partition are managed LRU; exceeding the partition
evicts that stream's own LRU page (no cross-stream interference once
partitioned — enforcement).

The pool is host bookkeeping (numpy and Python dicts), as the reference's.
Its allocator is the port's :class:`~repro_torch.core.cache_controller.
CacheController`: ``"numpy"`` (the default) is the host golden; the
reference's ``"jax"`` and ``"pallas"`` name the port's ``"device"``
backend, the batched greedy on the curves' device (the host curves here,
so its plain version on the CPU).  :meth:`PagedKVPool.reconfigure` returns
the partition as the reference does, an int64 numpy array.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Hashable, List

import numpy as np

from repro_torch.core.atd import StackDistanceMonitor
from repro_torch.core.cache_controller import CacheController


@dataclasses.dataclass
class StreamStats:
    """Per-stream counters with demand accesses separated from prefetch.

    ``hits``/``misses`` count DEMAND accesses only; readahead touches land
    in ``prefetch_hits``/``prefetch_misses``.  Algorithm 2 throttles on the
    demand hit-rate gain — folding prefetch touches into the same counters
    let the prefetcher inflate its own A/B signal (every readahead touch of
    an already-resident page counted as a "hit" the prefetcher caused).
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    prefetch_hits: int = 0
    prefetch_misses: int = 0

    @property
    def hit_rate(self) -> float:
        """Demand hit rate — the Algorithm-2 A/B signal."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def prefetch_hit_rate(self) -> float:
        total = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / total if total else 0.0


class PagedKVPool:
    """Fixed pool of KV pages partitioned across streams by CBP."""

    def __init__(self, total_pages: int, n_streams: int,
                 min_pages: int = 2, allocator_backend: str = "numpy"):
        if min_pages * n_streams > total_pages:
            raise ValueError("pool too small for min_pages floor")
        self.total_pages = total_pages
        self.n_streams = n_streams
        self.min_pages = min_pages
        # Backend-dispatched UCP/Lookahead (repro_torch.core.
        # cache_controller): "device" (the reference's "jax") runs the
        # batched greedy, useful when many pools reconfigure together.
        self.controller = CacheController(
            total_pages, min_pages, backend=allocator_backend)
        self.partition = np.full(n_streams, total_pages // n_streams,
                                 dtype=np.int64)
        self.partition[: total_pages - int(self.partition.sum())] += 1
        self._resident: List[OrderedDict] = [OrderedDict()
                                             for _ in range(n_streams)]
        self.monitors = [StackDistanceMonitor(total_pages)
                         for _ in range(n_streams)]
        self.stats = [StreamStats() for _ in range(n_streams)]

    # ---------------- access path ---------------- #

    def access(self, stream: int, page_key: Hashable,
               prefetch: bool = False) -> bool:
        """Touch a page; returns True on hit.  Misses insert the page,
        evicting the stream's LRU page when over partition.

        ``prefetch=True`` tags a readahead touch: it moves pages and feeds
        the stack-distance monitor exactly like a demand access (prefetched
        pages genuinely occupy the partition, so the utility curve must see
        them), but the hit/miss lands in the prefetch counters so
        :attr:`StreamStats.hit_rate` stays a pure demand signal.
        """
        self.monitors[stream].access(page_key)
        res = self._resident[stream]
        st = self.stats[stream]
        hit = page_key in res
        if hit:
            res.move_to_end(page_key)
            if prefetch:
                st.prefetch_hits += 1
            else:
                st.hits += 1
        else:
            if prefetch:
                st.prefetch_misses += 1
            else:
                st.misses += 1
            res[page_key] = True
        self._enforce(stream)
        return hit

    def _enforce(self, stream: int) -> None:
        res = self._resident[stream]
        limit = int(self.partition[stream])
        while len(res) > limit:
            res.popitem(last=False)
            self.stats[stream].evictions += 1

    # ---------------- CBP cache controller ---------------- #

    def utility_curves(self) -> np.ndarray:
        return np.stack([m.utility_curve() for m in self.monitors])

    def reconfigure(self) -> np.ndarray:
        """UCP/Lookahead over the measured stack-distance curves
        (paper §3.2.1), then halve the ATD counters (paper §3.3)."""
        curves = self.utility_curves()
        self.partition = (self.controller.allocate(curves).cpu().numpy()
                          .astype(np.int64))
        for m in self.monitors:
            m.halve()
        for s in range(self.n_streams):
            self._enforce(s)
        return self.partition

    def occupancy(self) -> np.ndarray:
        return np.array([len(r) for r in self._resident])
