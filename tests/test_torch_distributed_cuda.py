"""Sharding on the card, and the memory a dropped serving engine frees.

* ``run_sweep`` (all 14 managers over w1 and w2, 20 ms) and
  ``search_static`` (``fig5_smoke``'s 16 workloads, k = 3) under
  ``use_devices([cuda:0] * 2)`` and ``[cuda:0] * 7`` against the
  unsharded card run: discrete outputs (units, prefetch, indices) exactly
  equal, floats within rtol 1e-12.  The bound is a tolerance, not bit
  parity, because a CUDA reduction may take another order when a shard
  has fewer rows; each test prints the largest difference it saw.
* A ``GraphServingEngine`` on the qwen3-8b smoke model, run and dropped
  with the collector off, gives back every byte it allocated: nothing
  holds it in a reference cycle (``serving/engine_graph.py``'s programs
  hold the engine and the run weakly).  Its CPU companion runs the same
  path, the programs stood in by eager ones, and checks that a weak
  reference to the engine dies on ``del``; another that
  ``numpy_order_sum``, which the engine's bandwidth step calls, keeps
  nothing of its input.

The card tests need an NVIDIA card (``cuda`` marker; skipped without
one); on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_distributed_cuda.py``.  The file imports neither JAX
nor the JAX package.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from _torch_serving_ref import MAX_STEPS, fixtures

from repro_torch import configs, distributed
from repro_torch.models import build
from repro_torch.serving import EngineConfig, GraphServingEngine, Request
from repro_torch.serving import engine_graph
from repro_torch.sim import (
    MANAGER_NAMES,
    WORKLOADS,
    random_workloads,
    run_sweep,
    search_static,
)

RTOL = 1e-12
FIXTURE = next(iter(fixtures(EngineConfig).values()))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: sharded runs on the card are "
                    "held to the unsharded card run")
    return torch.device("cuda", 0)


def close(got, want, what: str) -> float:
    """Integers and booleans equal, floats within RTOL; the largest
    absolute difference."""
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=what)
    finite = np.isfinite(want)          # empty top-k slots hold -inf
    return float(np.abs(got[finite] - want[finite]).max(initial=0.0))


@pytest.fixture(scope="module")
def unsharded_sweep(card):
    return run_sweep([WORKLOADS["w1"], WORKLOADS["w2"]], total_ms=20.0)


@pytest.fixture(scope="module")
def unsharded_search(card):
    return search_static(random_workloads(16, 4, seed=7), k=3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 7])
def test_sweep_shards_on_the_card(card, unsharded_sweep, n_shards):
    want = unsharded_sweep
    with distributed.use_devices([card] * n_shards):
        got = run_sweep([WORKLOADS["w1"], WORKLOADS["w2"]], total_ms=20.0)
    worst = close(got.baseline_ipc, want.baseline_ipc, "baseline")
    for name in MANAGER_NAMES:
        a, b = got.final_alloc[name], want.final_alloc[name]
        worst = max(worst, close(got.ipc[name], want.ipc[name], name),
                    close(a.cache_units, b.cache_units, name),
                    close(a.bandwidth, b.bandwidth, name),
                    close(a.prefetch_on, b.prefetch_on, name))
    print(f"sweep on {n_shards} shards: max abs diff {worst!r}")


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 7])
def test_search_shards_on_the_card(card, unsharded_search, n_shards):
    want = unsharded_search
    with distributed.use_devices([card] * n_shards):
        got = search_static(random_workloads(16, 4, seed=7), k=3)
    worst = 0.0
    for name in want.family_names:
        close(got.topk_index[name], want.topk_index[name], name)
        worst = max(worst, close(got.topk_ws[name], want.topk_ws[name],
                                 name))
    print(f"search on {n_shards} shards: max abs diff {worst!r}")


def _serve_once(device) -> weakref.ref:
    """Build the smoke model and an engine on ``device``, run the first
    fixture, drop both; a weak reference to the engine."""
    n, ecfg, make, _groups = FIXTURE
    cfg = configs.get_smoke("qwen3-8b")
    model = build(cfg, device="cpu", seed=0).to(device)
    eng = GraphServingEngine(model, n, ecfg, device=device.type)
    eng.run(make(Request, cfg.vocab_size), max_steps=MAX_STEPS)
    assert eng.reconfigs > 0
    return weakref.ref(eng)


def _allocated() -> int:
    torch.cuda.synchronize()
    # cuBLAS keeps a workspace per (handle, stream), allocated on first
    # use on each new stream: not the engine's memory.
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


@pytest.mark.cuda
def test_dropped_engine_frees_its_memory_with_the_collector_off(card):
    _serve_once(card)                    # first-use set-up: kernel builds
    gc.collect()
    before = _allocated()
    enabled = gc.isenabled()
    gc.disable()
    try:
        ref = _serve_once(card)
        alive = ref() is not None
        after = _allocated()
    finally:
        if enabled:
            gc.enable()
    assert not alive
    assert after == before, (before, after)


class EagerProgram:
    """Stands in for :class:`repro_torch.graph.CapturedProgram` on the
    CPU: it keeps the function as a capture would and runs it eagerly."""

    def __init__(self, fn, device, replays):
        self._fn, self._replays = fn, replays
        self.seconds = {"warmup": 0.0, "capture": 0.0}

    def capture(self):
        self._fn()

    def run(self):
        self._replays.record()
        return self._fn()


def test_dropped_engine_dies_with_the_collector_off(monkeypatch):
    """The card's path (programs stored on the run, which the engine
    keeps) on the CPU: the engine goes with its last strong reference."""
    monkeypatch.setattr(engine_graph, "CapturedProgram", EagerProgram)
    real_init = GraphServingEngine.__init__

    def with_programs(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self._graphs = True

    monkeypatch.setattr(GraphServingEngine, "__init__", with_programs)
    enabled = gc.isenabled()
    gc.disable()
    try:
        ref = _serve_once(torch.device("cpu"))
        alive = ref() is not None
    finally:
        if enabled:
            gc.enable()
    assert not alive


@pytest.mark.parametrize("m", [4, 16, 256])
def test_numpy_order_sum_leaves_no_cycle(m):
    """The serving engine's bandwidth step, the banked model and the
    static search sum through ``numpy_order_sum``: with the collector off,
    its input goes with its last reference (a self-calling closure held
    it, 0.6 GB after the static search on the card)."""
    from repro_torch.numpy_order import numpy_order_sum

    enabled = gc.isenabled()
    gc.disable()
    try:
        vec = torch.arange(3.0 * m, dtype=torch.float64).reshape(3, m)
        ref = weakref.ref(vec)
        total = numpy_order_sum(vec)
        del vec
        alive = ref() is not None
    finally:
        if enabled:
            gc.enable()
    assert not alive
    assert total.shape == (3, 1)
