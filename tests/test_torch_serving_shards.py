"""The serving engine's groups sharded over devices
(``repro_torch.serving.engine_graph``), on the CPU under
``repro_torch.distributed.use_devices([cpu] * N)``.

* ``_plan_grid(n, d)`` is the reference's ``engine_jax._plan_grid`` with
  ``jax.device_count()`` at ``d``, for ``n`` in 1..16 and ``d`` in 1..8.
  Every such plan has ``K == a`` or ``b == 1``, so under the plan a
  block's groups are contiguous; ``_block_groups`` follows any grid, and
  the engine runs a forced ``(4, 4, 2, 2)`` grid whose blocks are not.
* Sharded against the unsharded engine at the same ``n_groups``, bit for
  bit in every attribute ``_finalize`` fills and every token (not
  ``idle_steps`` or ``capture_seconds``): the reference's parity fixture
  (``tests/test_serving_jax.py``'s ``_PARITY_SCRIPT``: 40 requests, seed
  7, 8 streams, 16 slots) at 8 groups on 2 and 8 devices and on 2
  devices through model replicas, and at 16 groups (16 streams) on 4
  devices, under the plan and under the forced grid.
* At 8 groups on 8 devices the tokens equal the port's host
  ``ServingEngine``'s under the token rule
  (``tests/_torch_serving_ref.py::token_rule``), as the reference's
  ``tests/test_serving_jax.py:291`` holds its sharded engine.
* The counter rules: ``serve_graph`` counts ``intervals`` times the
  blocks, ``serve_reconfig`` and the greedy's calls the sum of
  ``block_reconfigs``; ``idle_steps`` at one block is unchanged.
* Blocks on several cards launch their interval replays from a thread a
  block (programs stood in by eager ones), with the same outputs and
  counts.  A dropped sharded engine, its blocks on replicas, leaves
  nothing for the collector; a block that raises is not run elsewhere; a
  second run of a shape reuses every block's state.
* The engines' device check compares whole devices, index included.
"""
import gc
import threading
import types

import numpy as np
import pytest
import torch

from _torch_serving_ref import (
    parity_config,
    parity_requests,
    record_margins,
    token_rule,
    top2_torch,
)

from repro_torch import configs, distributed
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.device import same_device
from repro_torch.models import build
from repro_torch.serving import (
    EngineConfig,
    GraphServingEngine,
    Request,
    ServingEngine,
    engine,
    engine_graph,
)

CPU = torch.device("cpu")
MAX_STEPS = 300

#: Every attribute ``_finalize`` fills but ``idle_steps``.
FIELDS = ("steps", "reconfigs", "intervals", "slot_share", "queue_wait",
          "readahead", "partition", "occupancy", "evictions",
          "tokens_done", "demand_hits", "demand_misses", "prefetch_hits",
          "prefetch_misses", "demand_hit_rate", "prefetch_hit_rate")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The model is tiny: one intra-op thread runs its small ops fastest,
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build(configs.get_smoke("qwen3-8b"), device="cpu", seed=0)


def engine_on(model, n_streams, n_devices):
    """A ``GraphServingEngine`` over the parity configuration, one group a
    stream, planned over ``n_devices`` forced CPU devices."""
    with distributed.use_devices([CPU] * n_devices):
        return GraphServingEngine(model, n_streams,
                                  parity_config(EngineConfig),
                                  n_groups=n_streams, device="cpu")


def serve(model, n_streams, n_devices=1):
    """The parity fixture at ``n_streams`` streams, one group a stream,
    on ``n_devices`` forced CPU devices; (engine, requests, launch
    counts)."""
    eng = engine_on(model, n_streams, n_devices)
    reqs = parity_requests(Request, model.cfg.vocab_size, n_streams)
    reset_launch_counts()
    eng.run(reqs, max_steps=MAX_STEPS)
    return eng, reqs, launch_counts()


@pytest.fixture(scope="module")
def unsharded(model):
    return {n: serve(model, n) for n in (8, 16)}


def assert_same(got, want):
    (eng, reqs, _), (base, base_reqs, _) = got, want
    for key in FIELDS:
        np.testing.assert_array_equal(getattr(eng, key), getattr(base, key),
                                      err_msg=key)
    assert [r.generated for r in reqs] == [r.generated for r in base_reqs]


# ------------------------------------------------------------------ #
# the plan and the block layout
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n_devices", range(1, 9))
def test_plan_is_the_reference_plan(n_devices, monkeypatch):
    import jax

    from repro.serving import engine_jax

    monkeypatch.setattr(jax, "device_count", lambda: n_devices)
    for n in range(1, 17):
        plan = engine_graph._plan_grid(n, n_devices)
        assert plan == engine_jax._plan_grid(n), (n, n_devices)
        K, M, a, b = plan
        assert K == a or b == 1
        blocks = engine_graph._block_groups(*plan)
        assert [g for block in blocks for g in block] == list(range(n))


def test_block_groups_follow_the_grid():
    assert engine_graph._block_groups(4, 4, 2, 2) == [
        [0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13], [10, 11, 14, 15]]
    assert engine_graph._block_groups(6, 1, 3, 1) == [[0, 1], [2, 3], [4, 5]]
    assert engine_graph._block_groups(3, 1, 1, 1) == [[0, 1, 2]]


# ------------------------------------------------------------------ #
# parity with the unsharded engine
# ------------------------------------------------------------------ #

#: (streams = groups, forced devices, forced grid or None, replicas)
CASES = {
    "8-groups-on-2": (8, 2, None, False),
    "8-groups-on-8": (8, 8, None, False),
    "8-groups-on-2-replicas": (8, 2, None, True),
    "16-groups-on-4": (16, 4, None, False),
    "16-groups-on-4-grid-4x4": (16, 4, (4, 4, 2, 2), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_unsharded(case, model, unsharded, monkeypatch):
    n, n_devices, grid, replicas = CASES[case]
    if grid is not None:
        monkeypatch.setattr(engine_graph, "_plan_grid", lambda *_: grid)
    if replicas:      # every block on "another" device: a replica each
        monkeypatch.setattr(engine_graph, "same_device", lambda a, b: False)
    got = serve(model, n, n_devices)
    eng = got[0]
    assert len(eng.devices) == len(eng.block_groups) == n_devices
    assert sorted(g for b in eng.block_groups for g in b) == list(range(n))
    if grid is not None:
        assert eng.block_groups[0] == [0, 1, 4, 5]
    models = [run.model for run in eng._runs.values()]
    assert len(models) == n_devices
    assert all((m is model) != replicas for m in models)
    assert_same(got, unsharded[n])


@pytest.mark.parametrize("n_devices", [1, 8])
def test_counter_rules(n_devices, model, unsharded, monkeypatch):
    """One replay of each block's interval program an interval; each
    block's reconfigurations, summed, are the reconfiguration replays and
    the greedy's calls, a block's the most of its groups'."""
    calls, blocks_run = [], []
    real = engine_graph.lookahead_traced

    def greedy(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(engine_graph, "lookahead_traced", greedy)
    real_reconfigure = GraphServingEngine._reconfigure

    def reconfigure(self, run):
        blocks_run.append(run.block)
        return real_reconfigure(self, run)

    monkeypatch.setattr(GraphServingEngine, "_reconfigure", reconfigure)
    eng, _, counts = serve(model, 8, n_devices)
    base = unsharded[8][0]
    blocks = len(eng.block_groups)
    assert counts["serve_graph"] == eng.intervals * blocks
    assert counts["serve_reconfig"] == len(calls) == sum(eng.block_reconfigs)
    assert set(calls) == {len(b) for b in eng.block_groups}
    assert [blocks_run.count(b) for b in range(blocks)] == \
        eng.block_reconfigs == [int(run.q["reconfigs"].max())
                                for run in eng._runs.values()]
    for key in ("intervals", "steps", "reconfigs"):
        assert getattr(eng, key) == getattr(base, key), key
    if blocks == 1:
        assert eng.idle_steps == base.idle_steps
        assert eng.block_reconfigs == [base.reconfigs]
    assert eng.capture_seconds == {}


def test_sharded_tokens_equal_the_host_engine(model, unsharded):
    """``tests/test_serving_jax.py:291`` in the port: 8 groups on 8
    devices, tokens under the token rule against the host engine's."""
    cfg = parity_config(EngineConfig)
    host = ServingEngine(model, 8, cfg, device="cpu")
    margins = record_margins(host, top2_torch)
    want = parity_requests(Request, model.cfg.vocab_size, 8)
    host.run(want, max_steps=MAX_STEPS)
    eng, got, _ = serve(model, 8, 8)
    assert eng.grid == (2, 4, 2, 4)
    verdicts = [token_rule(g.generated, w.generated, margins.get(w.rid, []))
                for g, w in zip(got, want)]
    assert "differ" not in verdicts, verdicts
    assert all(r.generated is not None for r in got)


# ------------------------------------------------------------------ #
# lifetime, failures, reuse
# ------------------------------------------------------------------ #

class EagerProgram:
    """Stands in for :class:`repro_torch.graph.CapturedProgram` on the
    CPU: it keeps the function as a capture would and runs it eagerly;
    ``threads`` collects the threads its replays ran in."""

    threads: set = set()

    def __init__(self, fn, device, replays):
        self._fn, self._replays = fn, replays
        self.seconds = {"warmup": 0.0, "capture": 0.0}

    def capture(self):
        self._fn()

    def run(self):
        out = self.replay()
        self.record()
        return out

    def replay(self):
        EagerProgram.threads.add(threading.get_ident())
        return self._fn()

    def record(self):
        self._replays.record()


def test_blocks_on_several_cards_launch_from_threads(model, unsharded,
                                                     monkeypatch):
    """The card's path for blocks on several cards, on the CPU: each
    block's interval replay launched from a thread of its own, counted
    afterwards from the caller's; outputs bit for bit the unsharded
    engine's, one interval replay a block an interval."""
    monkeypatch.setattr(engine_graph, "CapturedProgram", EagerProgram)
    monkeypatch.setattr(EagerProgram, "threads", set())
    eng = engine_on(model, 8, 4)
    eng._graphs, eng._threads = True, 4
    reqs = parity_requests(Request, model.cfg.vocab_size, 8)
    reset_launch_counts()
    eng.run(reqs, max_steps=MAX_STEPS)
    counts = launch_counts()
    assert threading.get_ident() in EagerProgram.threads   # reconfigurations
    assert len(EagerProgram.threads) > 1
    assert counts["serve_graph"] == eng.intervals * 4
    assert counts["serve_reconfig"] == sum(eng.block_reconfigs)
    assert_same((eng, reqs, counts), unsharded[8])


def test_dropped_sharded_engine_leaves_no_cycle(model, monkeypatch):
    """The card's path (a program per block stored on its run, replicas
    kept by the engine) on the CPU: with the collector off the engine,
    its runs and its replicas go with its last reference."""
    monkeypatch.setattr(engine_graph, "CapturedProgram", EagerProgram)
    monkeypatch.setattr(engine_graph, "same_device", lambda a, b: False)
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        eng = engine_on(model, 8, 2)
        eng._graphs = True
        eng.run(parity_requests(Request, model.cfg.vocab_size, 8),
                max_steps=MAX_STEPS)
        assert set(eng.capture_seconds) == {
            f"block{b}/{which}_{k}" for b in (0, 1)
            for which in ("steps", "reconfigure")
            for k in ("warmup", "capture")}
        del eng
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        found = {type(o).__name__ for o in gc.garbage}
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if enabled:
            gc.enable()
    assert not found & {"GraphServingEngine", "_Run", "Model"}, found


def test_a_failing_block_raises(model, monkeypatch):
    """Block 1's interval raises: the run raises, and no other block or
    device runs it in its place."""
    eng = engine_on(model, 8, 2)
    real = eng._interval

    def fails_on_block_1(run):
        if run.block == 1:
            raise RuntimeError("block 1 failed")
        return real(run)

    monkeypatch.setattr(eng, "_interval", fails_on_block_1)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="block 1 failed"):
        eng.run(parity_requests(Request, model.cfg.vocab_size, 8),
                max_steps=MAX_STEPS)
    assert launch_counts()["serve_graph"] == 1


def test_second_sharded_run_reuses_every_block(model, unsharded):
    eng = engine_on(model, 8, 4)
    first = parity_requests(Request, model.cfg.vocab_size, 8)
    eng.run(first, max_steps=MAX_STEPS)
    state = {key: [v.data_ptr() for v in run.q.values()]
             for key, run in eng._runs.items()}
    again = parity_requests(Request, model.cfg.vocab_size, 8)
    eng.run(again, max_steps=MAX_STEPS)
    assert len(eng._runs) == 4
    assert {key: [v.data_ptr() for v in run.q.values()]
            for key, run in eng._runs.items()} == state
    assert_same((eng, again, None), unsharded[8])


def test_device_list_of_another_type_raises(model):
    with distributed.use_devices(["meta"] * 2):
        with pytest.raises(ValueError, match="not of the parameters' type"):
            GraphServingEngine(model, 8, parity_config(EngineConfig),
                               n_groups=8, device="cpu")


# ------------------------------------------------------------------ #
# the device check
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("a,b,current,same", [
    ("cuda:0", "cuda:1", 0, False),
    ("cuda", "cuda:0", 0, True),
    ("cuda", "cuda:0", 1, False),
    ("cuda", "cuda:1", 1, True),
    ("cpu", "cpu", 0, True),
    ("cpu", "meta", 0, False),
])
def test_same_device_compares_whole_devices(a, b, current, same,
                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    assert same_device(torch.device(a), torch.device(b)) is same
    assert same_device(b, a) is same


def test_engine_on_another_card_than_its_model_is_refused(monkeypatch):
    """A model on cuda:0 behind an engine asked for cuda:1 (or for a bare
    cuda whose current card is 1) is refused."""
    on_card_0 = types.SimpleNamespace(device=torch.device("cuda", 0))
    monkeypatch.setattr(engine, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for asked in ("cuda:1", "cuda"):
        with pytest.raises(ValueError, match="model is on cuda:0"):
            engine.check_model_device(on_card_0, asked)
    engine.check_model_device(on_card_0, "cuda:0")
