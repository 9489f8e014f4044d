"""Device-resident continuous-batching serving engine with CBP on the
device, as CUDA graphs (counterpart of :mod:`repro.serving.engine_jax`:
:class:`GraphServingEngine` is the port of ``JitServingEngine``).

The reference runs each reconfiguration interval as one jitted program: a
``lax.scan`` over decode steps with donated KV buffers, a device-side
pending-request queue, in-trace slot release and token-bucket admission,
and the three CBP knobs applied at the interval's end
(``lookahead_traced``, ``allocate_bandwidth_jax``,
``throttle_decision_jax``).  Here the same work runs on static tensors
that two programs update in place, each captured once into a CUDA graph
(:class:`repro_torch.graph.CapturedProgram`) and replayed:

  * the interval program: ``chunk`` decode steps (``reconfig_every_steps``),
    one replay an interval (counter ``serve_graph``);
  * the reconfiguration program: cache -> bandwidth -> prefetch, replayed
    after an interval in which some group advanced the whole interval
    (counter ``serve_reconfig``), so the Lookahead greedy kernel launches
    once per reconfiguration.

Between them the host reads one pair of flags ("any slot still active",
"some group advanced a full interval"): one host read an interval, as the
reference's run loop reads its "any active" scalar.  On the CPU both
programs run eagerly, and the counters count their runs all the same.

Scheduling is the reference's, op for op, rewritten as fixed-shape work
(a graph holds no host read, no boolean-mask indexing, no ``nonzero``):

  * admission: the reference's ``lax.while_loop`` admits at most one
    request per group a trip, into the lowest empty slot, and its body is
    a no-op once nothing can be admitted (the ``can`` gate).  A step can
    admit at most ``slots per group`` requests, so that many bodies,
    unrolled, give exactly the reference's schedule;
  * the reference's ``lax.cond`` skip of a step in which no group is live:
    every update of a step is gated by ``live``, so the step runs
    unconditionally and changes no queue state; it writes K/V rows of
    inactive slots at positions a later request overwrites before it
    reads them.  The wasted steps are counted (``idle_steps``);
  * ``mode="drop"`` scatters: writes that must not land go to a spare row
    and column of the output-token buffer, or add 0;
  * scatter-adds with repeated indices (the stack-distance histogram, the
    per-stream counters) use ``index_put_(..., accumulate=True)``: every
    addend is 1 or 0 onto a count (a dyadic rational, halved at each
    reconfiguration), so every partial sum is exact and the order of the
    adds cannot change a bit.

Arithmetic follows the reference's dtypes: float32 ``slot_share``,
``queue_wait``, ``sd_hist`` and ``last_rates``, int32 counters.  The
greedy takes float64 curves (:func:`~repro_torch.core.cache_controller.
lookahead_traced`), so the float32 cumulative histogram is cast to float64
before the call; the cast is exact.  Algorithm 1's delay total is summed
in numpy's order, the same on every device.

The decode is ``Model.decode_step(..., inplace=True)``: the cache stays in
its static buffers, as the reference's donated state does.  The first run
of a request shape ``(R, P, C)`` (requests per group, longest prompt, most
new tokens) captures each program just before its first replay;
:class:`CapturedProgram` runs its function once eagerly before capturing,
so the state is kept before and put back after.  A run with the same
shape replays only.

``n_groups`` splits streams, slots and pages into independent engine
groups, sharded over devices as the reference shards them
(``shard_grid``): the groups form a (K, M) grid planned over
:func:`repro_torch.distributed.device_list` (:func:`_plan_grid`, the
reference's plan), group ``g`` at ``(g // M, g % M)``, and block ``(i,
j)`` of its ``(a, b)`` split runs on device ``i * b + j`` of the list.
Unlike the reference, which splits and gathers the whole state every
interval, each block keeps its own queue state, KV cache and pair of
programs resident on its device for the run, and the queue state is
gathered into group order once, at the end.  A block on the model's
device runs the model itself (N blocks forced onto one card share its
weights); a block elsewhere runs a replica of it, built once per
engine.  Each interval every block's interval program is launched
first, from a thread a card where the blocks span several cards, then
each block's pair of flags is read (one host read a block, so blocks on
different cards overlap); a block replays its own
reconfiguration program when one of its groups advanced the whole
interval.  One card and no forced list plan ``(n_groups, 1, 1, 1)``:
one block, the unsharded engine.  The encoder-decoder family is refused
(its cache carries a batchless ``enc_len`` leaf).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import distributed
from repro_torch.core.bandwidth_controller import (
    allocate_bandwidth,
    check_bandwidth_floor,
)
from repro_torch.core.cache_controller import lookahead_traced
from repro_torch.core.dispatch import (
    SERVE_GRAPH_REPLAYS,
    SERVE_RECONFIG_REPLAYS,
)
from repro_torch.core.prefetch_controller import throttle_decision
from repro_torch.device import DeviceLike, same_device
from repro_torch.graph import CapturedProgram
from repro_torch.models.model import Model
from repro_torch.serving.engine import (
    EngineConfig,
    Request,
    check_model_device,
)

# Reconfiguration cadences above this run CBP-off: the interval is capped
# and the reconfiguration program is never built (the --no-cbp baselines
# use reconfig_every_steps=10**9).
_CHUNK_CAP = 1024
_OFF_CHUNK = 64

_I32, _F32 = torch.int32, torch.float32


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _plan_grid(n_groups: int, n_devices: int = 1
               ) -> Tuple[int, int, int, int]:
    """Arrange ``n_groups`` on a (K, M) grid sharded (a, b) ways over
    ``n_devices`` (the reference's plan): among plans using the most
    devices, the most balanced mesh wins, shard counts dividing K and M
    (one device plans ``(n_groups, 1, 1, 1)``)."""
    best, best_key = (n_groups, 1, 1, 1), (1, 1)
    for K in _divisors(n_groups):
        M = n_groups // K
        for a in _divisors(K):
            if a > n_devices:
                continue
            b = max(x for x in _divisors(M) if x <= n_devices // a)
            key = (a * b, min(a, b))
            if key > best_key:
                best_key, best = key, (K, M, a, b)
    return best


def _block_groups(K: int, M: int, a: int, b: int) -> List[List[int]]:
    """The groups of each block of the (K, M) grid split (a, b) ways, in
    device order (block ``(i, j)`` is device ``i * b + j``), each block's
    groups in row-major (k, m) order: not contiguous in ``g`` where a
    block spans more than one k and b > 1 (a grid :func:`_plan_grid`
    never plans: its plans have K == a or b == 1)."""
    Ka, Mb = K // a, M // b
    return [[k * M + m for k in range(i * Ka, (i + 1) * Ka)
             for m in range(j * Mb, (j + 1) * Mb)]
            for i in range(a) for j in range(b)]


def _replicate(model: Model, device: torch.device) -> Model:
    """A copy of ``model`` with its parameters moved to ``device`` (the
    reference's replicated ``params``)."""
    def moved(tree):
        return {k: moved(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    return Model(model.cfg, moved(model.params))


def _weak_call(obj, method: str, arg) -> Callable[[], torch.Tensor]:
    """``lambda: obj.method(arg)`` holding ``obj`` and ``arg`` weakly.  The
    engine keeps each run and the run its programs, so a program whose
    function held either would close a reference cycle: a dropped engine
    would keep its model, KV cache and graph memory pools until a
    collector pass."""
    obj_ref, arg_ref = weakref.ref(obj), weakref.ref(arg)
    return lambda: getattr(obj_ref(), method)(arg_ref())


def admission_body(c: Dict[str, torch.Tensor],
                   ctx: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One trip of the reference's admission loop (``engine_jax.py``
    ``adm_body``): per group, the lowest empty slot takes the first
    pending request (FIFO) of the pending stream with the largest deficit
    ``slot_share - stream_active`` (ties to the lowest stream).  Gated by
    ``can``: where a group cannot admit, nothing changes.  ``c`` holds the
    carried queue state, ``ctx`` what the trip reads only."""
    active, stream_active = c["active"], c["stream_active"]
    G, spg = active.shape
    R = c["admitted"].shape[1]
    npg = stream_active.shape[1]
    dev = active.device
    gi = torch.arange(G, device=dev)
    live, steps = ctx["live"], ctx["steps"]
    empty = ~active
    slot_i = torch.argmax(empty.to(_I32), dim=-1)                 # (G,)
    deficit = ctx["slot_share"] - stream_active.to(_F32)
    deficit = torch.where(c["pend_count"] > 0, deficit, -torch.inf)
    s = torch.argmax(deficit, dim=-1)                             # (G,)
    can = live & empty.any(-1) & (c["pend_count"].sum(-1) > 0)
    cand = (~c["admitted"] & ~ctx["done"]
            & (ctx["req_stream"] == s[:, None]))
    r = torch.argmax(cand.to(_I32), dim=-1)                       # FIFO
    can = can & cand.any(-1)
    at_slot = ((torch.arange(spg, device=dev)[None, :] == slot_i[:, None])
               & can[:, None])
    at_req = ((torch.arange(R, device=dev)[None, :] == r[:, None])
              & can[:, None])
    at_strm = torch.arange(npg, device=dev)[None, :] == s[:, None]
    inc = at_strm.to(_I32) * can.to(_I32)[:, None]
    wait = torch.where(
        can, (steps - ctx["enqueue_step"][gi, r]).to(_F32), 0.0)
    return {
        "active": active | at_slot,
        "slot_req": torch.where(at_slot, r[:, None].to(_I32), c["slot_req"]),
        "slot_stream": torch.where(at_slot, s[:, None].to(_I32),
                                   c["slot_stream"]),
        "pos": torch.where(at_slot, 0, c["pos"]),
        "tokens": torch.where(at_slot, ctx["prompts"][gi, r, 0][:, None],
                              c["tokens"]),
        "stream_active": stream_active + inc,
        "pend_count": c["pend_count"] - inc,
        # adds 0.0 off the admitted stream: the reference's scatter-add
        "queue_wait": c["queue_wait"] + torch.where(at_strm, wait[:, None],
                                                    0.0),
        "admitted": c["admitted"] | at_req,
    }


def admit(c: Dict[str, torch.Tensor],
          ctx: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's admission ``while_loop`` as a fixed unroll: a step
    admits at most one request per group per trip and only into an empty
    slot, so ``slots per group`` trips admit everything the loop would,
    and a trip past that is a no-op (``can`` is false)."""
    for _ in range(c["active"].shape[1]):
        c = admission_body(c, ctx)
    return c


@dataclasses.dataclass
class _Run:
    """One block's static tensors of one request shape, its model (the
    engine's, or a replica on the block's device) and its two
    programs."""

    block: int
    model: Model
    q: Dict[str, torch.Tensor]
    kv: Dict[str, torch.Tensor]
    start: torch.Tensor          # (G,) steps at the interval's start
    max_steps: torch.Tensor      # 0-D int32
    min_pages: torch.Tensor      # (G,) int32
    min_share: torch.Tensor      # 0-D float32
    threshold: torch.Tensor      # 0-D float32
    steps: Optional[CapturedProgram] = None
    reconfigure: Optional[CapturedProgram] = None


class GraphServingEngine:
    """Continuous batching + CBP as device programs replayed per interval
    (counterpart of ``repro.serving.engine_jax.JitServingEngine``).

    Same constructor surface as the host :class:`ServingEngine` plus
    ``n_groups`` (independent engine groups; streams, slots and pages
    must divide evenly) and ``min_pages``.  ``device`` (``None``: the
    card, raising without one) must be the model's, index included: on
    the card the programs run as CUDA graphs, on the CPU (``device="cpu"``)
    eagerly.  The groups are sharded over
    :func:`repro_torch.distributed.device_list` at construction (the
    module docstring says how): ``grid`` is the plan ``(K, M, a, b)``,
    ``devices`` the device of each block and ``block_groups`` its groups;
    a list of another device type raises.  ``run()`` fills the result
    attributes the reference's ``_finalize`` fills, plus the demand and
    prefetch hit/miss counts, ``idle_steps``, ``block_reconfigs`` and
    ``capture_seconds``.

    Counters and attributes over blocks: ``serve_graph`` counts replays,
    ``intervals`` times the blocks; ``serve_reconfig`` (and the greedy's
    launches) the reconfigurations each block ran, summed
    (``sum(block_reconfigs)``, a block's count the most of its groups');
    ``intervals``, ``steps`` and ``reconfigs`` (maxima over groups) equal
    the unsharded engine's; ``idle_steps`` sums each block's wasted step
    programs (the unsharded value at one block); ``capture_seconds`` holds
    the warm-up and capture seconds of each program captured in the last
    run (empty where it replayed only), keyed ``"steps_warmup"`` and so
    on, prefixed ``"block{i}/"`` where there is more than one block.
    Each warm-up before a capture runs its program once eagerly; a
    reconfiguration program's launches the greedy once.  A block whose
    program fails to capture or replay raises: no block moves to another
    device, and nothing runs eagerly in its place.
    """

    def __init__(self, model: Model, n_streams: int,
                 cfg: Optional[EngineConfig] = None, n_groups: int = 1,
                 min_pages: int = 2, device: DeviceLike = None):
        check_model_device(model, device)
        self.model = model
        self.cfg = cfg or EngineConfig()
        self.n_streams = n_streams
        if model.cfg.family == "encdec":
            raise ValueError("encdec caches carry a batchless enc_len leaf; "
                             "use the host ServingEngine")
        for name in ("n_streams", "batch_slots", "total_pages"):
            val = n_streams if name == "n_streams" else getattr(self.cfg,
                                                               name)
            if val % n_groups:
                raise ValueError(f"{name}={val} not divisible by "
                                 f"n_groups={n_groups}")
        self.n_groups = n_groups
        self._spg = self.cfg.batch_slots // n_groups       # slots/group
        self._npg = n_streams // n_groups                  # streams/group
        self._pages_pg = self.cfg.total_pages // n_groups  # pages/group
        self._min_pages = min_pages
        if min_pages * self._npg > self._pages_pg:
            raise ValueError("pool too small for min_pages floor")
        check_bandwidth_floor(self.cfg.min_slot_share, self._npg,
                              float(self._spg))
        self._cbp_on = self.cfg.reconfig_every_steps <= _CHUNK_CAP
        self._chunk = (self.cfg.reconfig_every_steps if self._cbp_on
                       else _OFF_CHUNK)
        devices = distributed.device_list(model.device)
        self.grid = _plan_grid(n_groups, len(devices))
        self.block_groups = _block_groups(*self.grid)
        self.devices = devices[:len(self.block_groups)]
        replicas = {}
        for dev in self.devices:
            if not same_device(dev, model.device) and dev not in replicas:
                replicas[dev] = _replicate(model, dev)
        self._models = [replicas.get(dev, model) for dev in self.devices]
        self._graphs = model.device.type == "cuda"
        # Threads that launch the blocks' interval replays: one a card
        # (on one card the replays run in turn whoever launches them).
        self._threads = len(set(self.devices)) if self._graphs else 1
        # (R, P, C, block) -> that block's run of the request shape
        self._runs: Dict[Tuple[int, int, int, int], _Run] = {}
        # filled by run():
        self.steps = 0
        self.reconfigs = 0
        self.intervals = 0
        self.idle_steps = 0
        self.block_reconfigs: List[int] = []
        self.capture_seconds: Dict[str, float] = {}

    # ------------------------------------------------------------- #
    # state construction (host side, once per run)
    # ------------------------------------------------------------- #

    def _build_state(self, requests: List[Request]) -> Dict[str, np.ndarray]:
        """The queue state as numpy arrays, primed (the reference's
        ``_build_state`` without the cache).  The output-token buffer has
        a spare request row and token column for writes that must not
        land."""
        G, spg, npg = self.n_groups, self._spg, self._npg
        per_group: List[List[int]] = [[] for _ in range(G)]
        for i, r in enumerate(requests):
            if not (0 <= r.stream < self.n_streams):
                raise ValueError(f"request stream {r.stream} out of range")
            if len(r.prompt) < 1:
                raise ValueError("empty prompt")
            r.rid = i
            per_group[r.stream // npg].append(i)
        R = max(1, max(len(g) for g in per_group))
        P = max(1, max((len(r.prompt) for r in requests), default=1))
        C = max(1, max((r.max_new_tokens for r in requests), default=1))
        self._req_loc = {}

        prompts = np.zeros((G, R, P), dtype=np.int32)
        prompt_len = np.ones((G, R), dtype=np.int32)
        req_stream = np.zeros((G, R), dtype=np.int32)
        max_new = np.zeros((G, R), dtype=np.int32)
        admitted = np.ones((G, R), dtype=bool)   # padding pre-admitted
        done = np.ones((G, R), dtype=bool)       # ... and pre-done
        enqueue_step = np.zeros((G, R), dtype=np.int32)
        pend_count = np.zeros((G, npg), dtype=np.int32)
        for g, idxs in enumerate(per_group):
            for r_loc, i in enumerate(idxs):
                req = requests[i]
                self._req_loc[i] = (g, r_loc)
                p = np.asarray(req.prompt, dtype=np.int32)
                prompts[g, r_loc, : len(p)] = p
                prompt_len[g, r_loc] = len(p)
                req_stream[g, r_loc] = req.stream % npg
                max_new[g, r_loc] = req.max_new_tokens
                admitted[g, r_loc] = False
                done[g, r_loc] = False
                pend_count[g, req.stream % npg] += 1

        U = self._pages_pg
        part = np.full((G, npg), U // npg, dtype=np.int32)
        part[:, : U - int(part[0].sum())] += 1
        q = {
            "tokens": np.zeros((G, spg), dtype=np.int32),
            "pos": np.zeros((G, spg), dtype=np.int32),
            "active": np.zeros((G, spg), dtype=bool),
            "slot_req": np.zeros((G, spg), dtype=np.int32),
            "slot_stream": np.zeros((G, spg), dtype=np.int32),
            "steps": np.zeros((G,), dtype=np.int32),
            "prompts": prompts, "prompt_len": prompt_len,
            "req_stream": req_stream, "max_new": max_new,
            "admitted": admitted, "done": done,
            "enqueue_step": enqueue_step, "pend_count": pend_count,
            "out_tokens": np.zeros((G, R + 1, C + 1), dtype=np.int32),
            "n_gen": np.zeros((G, R), dtype=np.int32),
            "partition": part,
            "slot_share": np.full((G, npg), spg / npg, dtype=np.float32),
            "readahead": np.zeros((G, npg), dtype=bool),
            "queue_wait": np.zeros((G, npg), dtype=np.float32),
            "stream_active": np.zeros((G, npg), dtype=np.int32),
            "sd_hist": np.zeros((G, npg, U + 1), dtype=np.float32),
            "demand_hits": np.zeros((G, npg), dtype=np.int32),
            "demand_misses": np.zeros((G, npg), dtype=np.int32),
            "prefetch_hits": np.zeros((G, npg), dtype=np.int32),
            "prefetch_misses": np.zeros((G, npg), dtype=np.int32),
            "occupancy": np.zeros((G, npg), dtype=np.int32),
            "evictions": np.zeros((G, npg), dtype=np.int32),
            "tokens_done": np.zeros((G, npg), dtype=np.int32),
            "last_rates": np.zeros((G, npg), dtype=np.float32),
            "reconfigs": np.zeros((G,), dtype=np.int32),
            "idle_steps": np.zeros((), dtype=np.int32),
        }
        self._prime(q)
        return q

    def _prime(self, q: Dict) -> None:
        """Initial admission, host-side numpy: the exact device pick
        (lowest empty slot; deficit argmax over pending streams, lowest
        stream index on ties; FIFO within the stream)."""
        G, spg = q["active"].shape
        for g in range(G):
            for i in range(spg):
                if not q["pend_count"][g].sum():
                    break
                deficit = (q["slot_share"][g]
                           - q["stream_active"][g].astype(np.float32))
                deficit = np.where(q["pend_count"][g] > 0, deficit, -np.inf)
                s = int(np.argmax(deficit))
                cand = (~q["admitted"][g] & ~q["done"][g]
                        & (q["req_stream"][g] == s))
                r = int(np.argmax(cand))
                q["admitted"][g, r] = True
                q["active"][g, i] = True
                q["slot_req"][g, i] = r
                q["slot_stream"][g, i] = s
                q["tokens"][g, i] = q["prompts"][g, r, 0]
                q["pos"][g, i] = 0
                q["stream_active"][g, s] += 1
                q["pend_count"][g, s] -= 1
                q["queue_wait"][g, s] += float(
                    q["steps"][g] - q["enqueue_step"][g, r])

    def _bind(self, host: Dict[str, np.ndarray]) -> List[_Run]:
        """Each block's static tensors for this request shape, filled
        with its groups' rows of ``host`` and an empty cache (allocated,
        and on the card captured, at the shape's first run)."""
        _, R1, C1 = host["out_tokens"].shape
        shape = (R1 - 1, host["prompts"].shape[2], C1 - 1)
        runs = []
        for b, (groups, model) in enumerate(zip(self.block_groups,
                                                self._models)):
            rows = {k: v if v.ndim == 0 else v[groups]
                    for k, v in host.items()}
            run = self._runs.get(shape + (b,))
            if run is None:
                run = self._new_run(b, model, rows)
                self._runs[shape + (b,)] = run
            else:
                for k, v in rows.items():
                    run.q[k].copy_(torch.as_tensor(v))
                for leaf in run.kv.values():
                    leaf.zero_()
            runs.append(run)
        return runs

    def _new_run(self, block: int, model: Model,
                 rows: Dict[str, np.ndarray]) -> _Run:
        G = len(self.block_groups[block])
        S = G * self._spg
        dev = model.device
        kv = model.init_cache(S, self.cfg.max_len, dtype=_F32)
        for leaf in kv.values():
            if leaf.dim() < 2 or leaf.shape[1] != S:
                raise ValueError(
                    "cache leaf without a slot axis at position 1: "
                    f"shape {tuple(leaf.shape)} (family "
                    f"{model.cfg.family})")
        return _Run(
            block=block, model=model,
            q={k: torch.as_tensor(v, device=dev).clone()
               for k, v in rows.items()},
            kv=kv,
            start=torch.zeros((G,), dtype=_I32, device=dev),
            max_steps=torch.zeros((), dtype=_I32, device=dev),
            min_pages=torch.full((G,), self._min_pages, dtype=_I32,
                                 device=dev),
            min_share=torch.tensor(self.cfg.min_slot_share, dtype=_F32,
                                   device=dev),
            threshold=torch.tensor(self.cfg.speedup_threshold, dtype=_F32,
                                   device=dev))

    def _captured(self, run: _Run, which: str) -> CapturedProgram:
        """``run``'s interval or reconfiguration program, captured on its
        block's card just before its first replay.  A capture runs the
        function once eagerly first, which would advance the state: the
        state is kept before and put back after, in place.  So the
        reconfiguration program's warm-up sees the first boundary's own
        inputs."""
        program = getattr(run, which)
        if program is None:
            fn, counter = ((_weak_call(self, "_interval", run),
                            SERVE_GRAPH_REPLAYS) if which == "steps" else
                           (_weak_call(self, "_reconfigure", run),
                            SERVE_RECONFIG_REPLAYS))
            saved = {k: v.clone() for k, v in run.q.items()}
            saved_kv = ({k: v.clone() for k, v in run.kv.items()}
                        if which == "steps" else {})
            program = CapturedProgram(fn, run.model.device, counter)
            program.capture()
            for k, v in saved.items():
                run.q[k].copy_(v)
            for k, v in saved_kv.items():
                run.kv[k].copy_(v)
            setattr(run, which, program)
            prefix = f"block{run.block}/" if len(self.devices) > 1 else ""
            self.capture_seconds.update(
                {f"{prefix}{which}_{k}": v
                 for k, v in program.seconds.items()})
        return program

    def _launch(self, run: _Run, which: str) -> torch.Tensor:
        """One run of ``run``'s interval (``"steps"``) or reconfiguration
        program: a replay on the card, an eager call on the CPU, counted
        alike."""
        if self._graphs:
            return self._captured(run, which).run()
        if which == "steps":
            out = self._interval(run)
            SERVE_GRAPH_REPLAYS.record()
        else:
            out = self._reconfigure(run)
            SERVE_RECONFIG_REPLAYS.record()
        return out

    # ------------------------------------------------------------- #
    # the device programs (no host read inside)
    # ------------------------------------------------------------- #

    def _one_step(self, run: _Run) -> None:
        cfgE = self.cfg
        q = run.q
        G, spg = q["active"].shape
        R = q["admitted"].shape[1]
        P = q["prompts"].shape[2]
        C = q["out_tokens"].shape[2] - 1
        U = self._pages_pg
        dev = q["active"].device
        gi = torch.arange(G, device=dev)
        gi2 = gi[:, None].expand(G, spg)
        live = q["active"].any(-1) & (q["steps"] < run.max_steps)   # (G,)
        upd = q["active"] & live[:, None]                           # (G, spg)

        # ---- decode every slot at ITS position ---------------------------
        logits, _ = run.model.decode_step(
            run.kv, q["tokens"].reshape(G * spg, 1),
            q["pos"].reshape(G * spg), inplace=True)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(_I32).reshape(G, spg)

        # ---- coarse paged-KV accounting at the current position ---------
        strm = q["slot_stream"].long()
        ra = torch.gather(q["readahead"], 1, strm)
        acnt = torch.gather(q["stream_active"], 1, strm)
        part = torch.gather(q["partition"], 1, strm)
        new_page = (q["pos"] % cfgE.page_tokens) == 0
        d_re = acnt * (1 + ra.to(_I32)) - 1
        cold = (q["pos"] == 0) | (new_page & ~ra)
        dist = torch.where(cold, U, torch.clamp(d_re, max=U))
        hit = upd & ~cold & (dist < part)
        miss = upd & ~hit

        def add_at(t, idx, vals):
            # A slot whose value is 0 adds nothing wherever it points (an
            # idle slot's distance may be -1); its index is clamped.
            return t.index_put((gi2, idx.clamp(min=0).long()),
                               vals.to(t.dtype), accumulate=True)

        sd_hist = q["sd_hist"].index_put(
            (gi2, strm, dist.clamp(min=0).long()), upd.to(_F32),
            accumulate=True)
        # readahead touch of (page + 1): first touch per page is a cold
        # insert, later touches re-touch at the same coarse distance.
        pf = upd & ra
        pf_hit = pf & ~new_page & (d_re < part)
        pf_miss = pf & ~pf_hit
        pf_idx = torch.where(new_page, U, torch.clamp(d_re, max=U))
        sd_hist = sd_hist.index_put(
            (gi2, strm, pf_idx.clamp(min=0).long()), pf.to(_F32),
            accumulate=True)
        demand_hits = add_at(q["demand_hits"], strm, hit)
        demand_misses = add_at(q["demand_misses"], strm, miss)
        prefetch_hits = add_at(q["prefetch_hits"], strm, pf_hit)
        prefetch_misses = add_at(q["prefetch_misses"], strm, pf_miss)
        occupancy = add_at(q["occupancy"], strm,
                           miss.to(_I32) + pf_miss.to(_I32))
        over = torch.clamp(occupancy - q["partition"], min=0)  # LRU
        evictions = q["evictions"] + over
        occupancy = occupancy - over
        tokens_done = add_at(q["tokens_done"], strm, upd)

        # ---- advance: teacher-force the prompt, emit, retire ------------
        slot_req = q["slot_req"].long()
        p1 = q["pos"] + 1
        plen = torch.gather(q["prompt_len"], 1, slot_req)
        prompt_tok = q["prompts"][gi2, slot_req, p1.clamp(0, P - 1).long()]
        in_prompt = p1 < plen
        tok_next = torch.where(in_prompt, prompt_tok, nxt)
        gen_now = upd & ~in_prompt
        ci = torch.gather(q["n_gen"], 1, slot_req)
        # A token lands at (request, count) only where generated; the rest
        # go to the spare row R, column C.
        out_tokens = q["out_tokens"].index_put(
            (gi2, torch.where(gen_now, slot_req, R),
             torch.where(gen_now, ci, C).long()), nxt)
        n_gen = add_at(q["n_gen"], slot_req, gen_now)
        maxnew = torch.gather(q["max_new"], 1, slot_req)
        ng_after = ci + gen_now.to(_I32)
        done_now = upd & ((ng_after >= maxnew) | (p1 >= cfgE.max_len - 1))
        tokens = torch.where(upd, tok_next, q["tokens"])
        pos = torch.where(upd, p1, q["pos"])
        active = q["active"] & ~done_now
        stream_active = add_at(q["stream_active"], strm, -done_now.to(_I32))
        done = q["done"] | (add_at(torch.zeros_like(q["n_gen"]), slot_req,
                                   done_now) > 0)

        # ---- admission: one request per group per body, spg bodies ------
        adm = admit(
            {"active": active, "slot_req": q["slot_req"],
             "slot_stream": q["slot_stream"], "pos": pos, "tokens": tokens,
             "stream_active": stream_active, "pend_count": q["pend_count"],
             "queue_wait": q["queue_wait"], "admitted": q["admitted"]},
            {"live": live, "done": done, "slot_share": q["slot_share"],
             "req_stream": q["req_stream"], "prompts": q["prompts"],
             "enqueue_step": q["enqueue_step"], "steps": q["steps"]})

        new = dict(
            adm, steps=q["steps"] + live.to(_I32), done=done,
            out_tokens=out_tokens, n_gen=n_gen, sd_hist=sd_hist,
            demand_hits=demand_hits, demand_misses=demand_misses,
            prefetch_hits=prefetch_hits, prefetch_misses=prefetch_misses,
            occupancy=occupancy, evictions=evictions,
            tokens_done=tokens_done,
            idle_steps=q["idle_steps"] + (~live.any()).to(_I32))
        for k, v in new.items():
            q[k].copy_(v)

    def _interval(self, run: _Run) -> torch.Tensor:
        """``chunk`` decode steps; returns (any slot active, some group
        advanced the whole interval) as a (2,) bool tensor."""
        q = run.q
        run.start.copy_(q["steps"])
        for _ in range(self._chunk):
            self._one_step(run)
        return torch.stack([q["active"].any(),
                            (q["steps"] - run.start == self._chunk).any()])

    def _reconfigure(self, run: _Run) -> torch.Tensor:
        """Cache -> bandwidth -> prefetch, the paper's priority order,
        gated per group on having advanced a full interval (freezing, all
        done or at ``max_steps``, is permanent, so a group either advanced
        the whole interval or never will again)."""
        q = run.q
        G, n = q["partition"].shape
        U = self._pages_pg
        did_full = (q["steps"] - run.start) == self._chunk
        a1 = did_full[:, None]
        # 1. cache: UCP/Lookahead over the coarse stack-distance curves
        # (curve[0] = 0; curve[k] = hits with k pages = cumsum of the
        # finite-distance histogram), cast exactly to float64.
        hist = q["sd_hist"]
        curve = torch.cat(
            [torch.zeros((G, n, 1), dtype=_F32, device=hist.device),
             torch.cumsum(hist[..., :U], dim=-1)], dim=-1)
        part_new = lookahead_traced(curve.to(torch.float64), run.min_pages,
                                    U).to(_I32)
        partition = torch.where(a1, part_new, q["partition"])
        sd_hist = torch.where(did_full[:, None, None], hist * 0.5, hist)
        over = torch.where(a1, torch.clamp(q["occupancy"] - partition,
                                           min=0), 0)
        evictions = q["evictions"] + over
        occupancy = q["occupancy"] - over
        # 2. bandwidth: Algorithm 1 over accumulated queue wait
        share_new = allocate_bandwidth(q["queue_wait"] + 1e-6,
                                       float(self._spg), run.min_share,
                                       numpy_order=True)
        slot_share = torch.where(a1, share_new, q["slot_share"])
        queue_wait = torch.where(a1, q["queue_wait"] * 0.5, q["queue_wait"])
        # 3. prefetch: Algorithm 2 on the DEMAND hit-rate gain
        tot = q["demand_hits"] + q["demand_misses"]
        rates = torch.where(tot > 0,
                            q["demand_hits"].to(_F32)
                            / torch.clamp(tot, min=1).to(_F32), 0.0)
        base = torch.where((q["reconfigs"] == 0)[:, None], rates,
                           q["last_rates"])
        ra_new = throttle_decision(rates + 1e-9, base + 1e-9, run.threshold)
        new = dict(
            partition=partition, sd_hist=sd_hist, evictions=evictions,
            occupancy=occupancy, slot_share=slot_share,
            queue_wait=queue_wait,
            readahead=torch.where(a1, ra_new, q["readahead"]),
            last_rates=torch.where(a1, rates, q["last_rates"]),
            reconfigs=q["reconfigs"] + did_full.to(_I32))
        for k, v in new.items():
            q[k].copy_(v)
        return q["reconfigs"]

    # ------------------------------------------------------------- #
    # the run loop
    # ------------------------------------------------------------- #

    def run(self, requests: List[Request], max_steps: int = 10_000
            ) -> List[Request]:
        """Continuous batching over the request list; per interval, one
        replay of each block's interval program, one of a block's
        reconfiguration program per reconfiguration it runs, and one host
        read of each block's two flags after every block was launched."""
        if not requests:
            return requests
        runs = self._bind(self._build_state(requests))
        for run in runs:
            run.max_steps.fill_(min(max_steps, np.iinfo(np.int32).max))
        self.capture_seconds = {}
        n_intervals = max(1, math.ceil(max_steps / self._chunk))
        self.intervals = 0
        with (ThreadPoolExecutor(self._threads) if self._threads > 1
              else contextlib.nullcontext()) as pool:
            for _ in range(n_intervals):
                flags = [f.tolist() for f in self._intervals(runs, pool)]
                self.intervals += 1
                if self._cbp_on:
                    for run, (_, any_full) in zip(runs, flags):
                        if any_full:
                            self._launch(run, "reconfigure")
                if not any(any_active for any_active, _ in flags):
                    break
        self._finalize(runs, requests)
        return requests

    def _intervals(self, runs: List[_Run],
                   pool: Optional[ThreadPoolExecutor]) -> List[torch.Tensor]:
        """Every block's interval program, all launched before any flag is
        read.  With ``pool`` (blocks on several cards) each is captured in
        turn from this thread, then replayed from a thread of its own and
        counted here: a large graph's launch holds its host thread for
        most of the graph's run, so replays launched from one thread
        would run one card after another."""
        if pool is None:
            return [self._launch(run, "steps") for run in runs]
        programs = [self._captured(run, "steps") for run in runs]
        outs = list(pool.map(lambda program: program.replay(), programs))
        for program in programs:
            program.record()
        return outs

    def _gather(self, runs: List[_Run]) -> Dict[str, np.ndarray]:
        """The blocks' queue states as one, in group order (0-D counters
        summed over blocks)."""
        blocks = [{k: v.cpu().numpy() for k, v in run.q.items()}
                  for run in runs]
        q = {}
        for k, v in blocks[0].items():
            if v.ndim == 0:
                q[k] = sum(b[k] for b in blocks)
                continue
            q[k] = np.empty((self.n_groups,) + v.shape[1:], dtype=v.dtype)
            for groups, b in zip(self.block_groups, blocks):
                q[k][groups] = b[k]
        return q

    def _finalize(self, runs: List[_Run], requests: List[Request]) -> None:
        q = self._gather(runs)
        for i, req in enumerate(requests):
            g, r = self._req_loc[i]
            if q["admitted"][g, r]:
                k = int(q["n_gen"][g, r])
                req.generated = [int(t) for t in q["out_tokens"][g, r, :k]]

        def flat(name):
            return q[name].reshape(-1)  # stream s = g * npg + s_local

        self.steps = int(q["steps"].max())
        self.reconfigs = int(q["reconfigs"].max())
        self.block_reconfigs = [int(q["reconfigs"][groups].max())
                                for groups in self.block_groups]
        self.idle_steps = int(q["idle_steps"])
        self.slot_share = flat("slot_share").astype(np.float64)
        self.queue_wait = flat("queue_wait").astype(np.float64)
        self.readahead = flat("readahead")
        self.partition = flat("partition").astype(np.int64)
        self.occupancy = flat("occupancy").astype(np.int64)
        self.evictions = flat("evictions").astype(np.int64)
        self.tokens_done = flat("tokens_done").astype(np.float64)
        hits, misses = flat("demand_hits"), flat("demand_misses")
        ph, pm = flat("prefetch_hits"), flat("prefetch_misses")
        self.demand_hits, self.demand_misses = hits.astype(np.int64), \
            misses.astype(np.int64)
        self.prefetch_hits, self.prefetch_misses = ph.astype(np.int64), \
            pm.astype(np.int64)
        tot = np.maximum(hits + misses, 1)
        self.demand_hit_rate = np.where(hits + misses > 0,
                                        hits / tot, 0.0)
        self.prefetch_hit_rate = np.where(ph + pm > 0,
                                          ph / np.maximum(ph + pm, 1), 0.0)
