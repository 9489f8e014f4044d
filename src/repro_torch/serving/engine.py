"""Batched serving engine with full CBP coordination, the host loop
(counterpart of :mod:`repro.serving.engine`).

The engine runs greedy decode over a fixed slot batch (continuous batching:
finished requests release their slot to the queue) and binds all three CBP
knobs:

  * cache      — the :class:`PagedKVPool` partitions KV pages across
    request streams (UCP over stack-distance curves);
  * bandwidth  — per-stream token-bucket admission: each stream's share of
    decode slots is allocated proportionally to its measured queue wait
    (Algorithm 1, units = slots/interval instead of GB/s);
  * prefetch   — KV-page readahead per stream, A/B sampled and throttled
    by the measured DEMAND hit-rate speedup (Algorithm 2; readahead
    touches are tagged prefetch in the pool so they cannot inflate their
    own A/B signal).

This host loop is the golden reference for the device engine
(:mod:`repro_torch.serving.engine_graph`), and it keeps the reference's
scheduling rules op for op:

  * per-slot positions travel to ``decode_step`` as a VECTOR, so a newly
    admitted slot decodes at ITS position 0 while its neighbours sit
    mid-sequence;
  * queue wait is accounted in decode STEPS keyed by an engine-assigned
    request id, and a wait recorded at step 0 counts (``is not None``);
  * the token-bucket admission pick is a per-STREAM deficit argmax with a
    lowest-stream-index tie-break, then FIFO within the winning stream.

The decode step is the port's ``Model.decode_step`` with the cache written
in place; the argmax of each step's logits is the one host read a step.
The controllers are the port's (:func:`~repro_torch.core.
bandwidth_controller.allocate_bandwidth` with the delay total in numpy's
order, :func:`~repro_torch.core.prefetch_controller.throttle_decision`),
run on float64 CPU tensors, so every share and readahead decision is the
reference's numpy result bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.bandwidth_controller import (
    allocate_bandwidth,
    check_bandwidth_floor,
)
from repro_torch.core.prefetch_controller import throttle_decision
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.models.model import Model
from repro_torch.serving.kv_cache import PagedKVPool


@dataclasses.dataclass
class Request:
    stream: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    # filled in by the engine:
    generated: Optional[List[int]] = None
    slot: int = -1
    pages_touched: int = 0
    rid: int = -1                      # engine-assigned id; stable across
    #                                    re-admission (id(req) is not)


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 4
    max_len: int = 128
    page_tokens: int = 16              # tokens per KV page
    total_pages: int = 64
    reconfig_every_steps: int = 32     # CBP reconfiguration interval
    speedup_threshold: float = 1.05
    min_slot_share: float = 0.5


def check_model_device(model: Model, device: DeviceLike) -> None:
    """Resolve an engine's ``device`` (``None``: the card, raising without
    one) and require the model to be there, index included."""
    dev = resolve_device(device)
    if not same_device(model.device, dev):
        raise ValueError(f"the model is on {model.device}, the engine on "
                         f"{dev}: build the model on the engine's device")


class ServingEngine:
    """The host engine over the port's :class:`~repro_torch.models.model.
    Model`.  The constructor is the reference's without ``params``
    (``ServingEngine(model, n_streams, cfg)``): the port's model carries
    its parameters, as its facade's methods do.  ``device`` (``None``: the
    card, raising without one; ``"cpu"`` must be asked for) is where the
    model, and so the decode and the float32 KV cache, live."""

    def __init__(self, model: Model, n_streams: int,
                 cfg: Optional[EngineConfig] = None,
                 device: DeviceLike = None):
        check_model_device(model, device)
        self.model = model
        self.cfg = cfg or EngineConfig()
        self.n_streams = n_streams
        check_bandwidth_floor(self.cfg.min_slot_share, n_streams,
                              float(self.cfg.batch_slots))
        self.pool = PagedKVPool(self.cfg.total_pages, n_streams)
        self.kv = model.init_cache(self.cfg.batch_slots, self.cfg.max_len,
                                   dtype=torch.float32)
        self._decode = functools.partial(model.decode_step, inplace=True)
        # CBP state
        self.slot_share = np.full(n_streams,
                                  self.cfg.batch_slots / n_streams)
        self.readahead = np.zeros(n_streams, dtype=bool)
        self.queue_wait = np.zeros(n_streams)
        self.tokens_done = np.zeros(n_streams)
        self.steps = 0
        self.reconfigs = 0
        self._next_rid = 0

    # ------------------------------------------------------------- #

    def _touch_pages(self, req: Request, pos: int) -> None:
        page = pos // self.cfg.page_tokens
        self.pool.access(req.stream, (req.stream, req.rid, page))
        if self.readahead[req.stream]:
            self.pool.access(req.stream, (req.stream, req.rid, page + 1),
                             prefetch=True)
        req.pages_touched += 1

    def run(self, requests: List[Request], max_steps: int = 10_000
            ) -> List[Request]:
        """Continuous batching over the request list."""
        cfgE = self.cfg
        dev = self.model.device
        pending: List[Request] = list(requests)
        active: List[Optional[Request]] = [None] * cfgE.batch_slots
        tokens = np.zeros((cfgE.batch_slots, 1), dtype=np.int32)
        pos = np.zeros(cfgE.batch_slots, dtype=np.int64)
        enqueue_step: Dict[int, int] = {}
        stream_active = np.zeros(self.n_streams)

        def admit():
            for i in range(cfgE.batch_slots):
                if active[i] is not None:
                    continue
                if not pending:
                    break
                # token-bucket: the pending STREAM most under its slot
                # share wins; exact deficit ties break to the lowest
                # stream index, then FIFO within the stream.
                deficit = self.slot_share - stream_active
                has_pending = np.zeros(self.n_streams, dtype=bool)
                for r in pending:
                    has_pending[r.stream] = True
                deficit = np.where(has_pending, deficit, -np.inf)
                s = int(np.argmax(deficit))   # first max = lowest index
                best_j = next(j for j, r in enumerate(pending)
                              if r.stream == s)
                req = pending.pop(best_j)
                req.generated = []
                req.slot = i
                active[i] = req
                stream_active[req.stream] += 1
                t_in = enqueue_step.pop(req.rid, None)
                # `is not None`: step 0 is a perfectly valid enqueue tick.
                self.queue_wait[req.stream] += (
                    self.steps - t_in if t_in is not None else 0.0)
                tokens[i, 0] = req.prompt[0]
                pos[i] = 0

        for r in pending:
            r.rid = self._next_rid
            self._next_rid += 1
            enqueue_step[r.rid] = self.steps
        admit()

        steps = 0
        while any(a is not None for a in active) and steps < max_steps:
            # Per-slot positions go down as a VECTOR: each slot writes and
            # attends at its own position.
            logits, self.kv = self._decode(
                self.kv, torch.as_tensor(tokens, device=dev),
                torch.as_tensor(pos, dtype=torch.int32, device=dev))
            nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
            for i, req in enumerate(active):
                if req is None:
                    continue
                self._touch_pages(req, int(pos[i]))
                p = int(pos[i]) + 1
                if p < len(req.prompt):
                    tokens[i, 0] = req.prompt[p]      # teacher-force prompt
                else:
                    req.generated.append(int(nxt[i]))
                    tokens[i, 0] = int(nxt[i])
                pos[i] = p
                self.tokens_done[req.stream] += 1
                done = (len(req.generated) >= req.max_new_tokens
                        or p >= cfgE.max_len - 1)
                if done:
                    stream_active[req.stream] -= 1
                    active[i] = None
            admit()
            steps += 1
            self.steps += 1
            if self.steps % cfgE.reconfig_every_steps == 0:
                self._reconfigure()
        return requests

    # ---------------- CBP coordination ---------------- #

    def _reconfigure(self) -> None:
        """Priority order per the paper: cache -> bandwidth -> prefetch."""
        self.reconfigs += 1
        # 1. cache: UCP over stack-distance curves
        self.pool.reconfigure()
        # 2. bandwidth: slots proportional to queue wait (Algorithm 1)
        self.slot_share = allocate_bandwidth(
            torch.as_tensor(self.queue_wait + 1e-6),
            float(self.cfg.batch_slots), self.cfg.min_slot_share,
            numpy_order=True).numpy()
        self.queue_wait *= 0.5  # accumulate-with-decay (paper §3.3)
        # 3. prefetch: A/B throttle readahead on per-stream DEMAND
        # hit-rate gain: enable readahead for streams whose demand hit
        # rate improved while it was on — prefetch touches are tagged in
        # the pool and excluded here.
        rates = np.array([s.hit_rate for s in self.pool.stats])
        base = getattr(self, "_last_rates", rates)
        self.readahead = throttle_decision(
            torch.as_tensor(rates + 1e-9), torch.as_tensor(base + 1e-9),
            self.cfg.speedup_threshold).numpy()
        self._last_rates = rates
