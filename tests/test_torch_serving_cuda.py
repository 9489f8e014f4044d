"""The serving path on the card against the port's own CPU run.

The reference test's fixtures (``tests/_torch_serving_ref.py``) with the
qwen3-8b smoke model, float32, built from a seed on the CPU and copied to
the card, TF32 off: the host engine and ``GraphServingEngine`` on the
card equal their CPU runs in every output (schedule, tokens, pool,
counters).  The device engine's first run of a request shape captures
its two programs (interval and reconfiguration) without advancing the
state: the interval program replays once an interval, the
reconfiguration program once a reconfiguration, and the greedy kernel
launches once per reconfiguration, plus once in the warm-up before the
reconfiguration program's capture; a second run replays only.  The
greedy on the engine's first-boundary inputs equals its plain version.
A capture that fails raises; nothing falls back to an eager run.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_serving_cuda.py``.  The file imports neither JAX nor the
JAX package.
"""
import copy

import numpy as np
import pytest
import torch

from _torch_serving_ref import MAX_STEPS, fixtures

from repro_torch import configs, distributed
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.models import build
from repro_torch.serving import (
    EngineConfig,
    GraphServingEngine,
    Request,
    ServingEngine,
)

pytestmark = pytest.mark.cuda

FIXTURES = fixtures(EngineConfig)
CASES = [(name, kind) for name, spec in FIXTURES.items()
         for kind in ["host"] + [f"graph{g}" for g in spec[3]]]


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the serving engines' card runs "
                    "are held to their CPU runs")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build(configs.get_smoke("qwen3-8b"), device="cpu", seed=0)
    yield cpu, copy.deepcopy(cpu).to("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def engine(model, name, kind):
    """The engine of ``kind`` over ``model``; a device engine on the
    model's one device (its groups unsharded on a machine with more
    cards, as on the CPU)."""
    n, ecfg, _, _ = FIXTURES[name]
    dev = model.device.type
    if kind == "host":
        return ServingEngine(model, n, ecfg, device=dev)
    with distributed.use_devices([model.device]):
        return GraphServingEngine(model, n, ecfg, n_groups=int(kind[5:]),
                                  device=dev)


def outputs(eng, name, vocab):
    reqs = FIXTURES[name][2](Request, vocab)
    reset_launch_counts()
    eng.run(reqs, max_steps=MAX_STEPS)
    out = {"tokens": [r.generated for r in reqs], "steps": eng.steps,
           "reconfigs": eng.reconfigs,
           "queue_wait": list(eng.queue_wait),
           "slot_share": list(eng.slot_share),
           "tokens_done": list(eng.tokens_done),
           "readahead": list(np.asarray(eng.readahead))}
    if isinstance(eng, ServingEngine):
        out.update(partition=list(eng.pool.partition),
                   occupancy=list(eng.pool.occupancy()),
                   stats=[vars(s) for s in eng.pool.stats])
    else:
        out.update({k: list(getattr(eng, k)) for k in (
            "partition", "occupancy", "evictions", "demand_hits",
            "demand_misses", "prefetch_hits", "prefetch_misses")},
            intervals=eng.intervals, idle_steps=eng.idle_steps)
    return out, launch_counts()


@pytest.mark.parametrize("name,kind", CASES)
def test_card_equals_cpu(models, name, kind):
    cpu, card = models
    vocab = cpu.cfg.vocab_size
    want, _ = outputs(engine(cpu, name, kind), name, vocab)
    got, counts = outputs(engine(card, name, kind), name, vocab)
    assert got == want
    if kind != "host":
        cbp = FIXTURES[name][1].reconfig_every_steps <= 1024
        assert counts["serve_graph"] == got["intervals"]
        assert counts["serve_reconfig"] == got["reconfigs"]
        assert counts["lookahead_greedy"] == got["reconfigs"] + int(cbp)


def test_warm_run_replays_without_capture(models):
    _, card = models
    eng = engine(card, "main", "graph1")
    cold, cold_counts = outputs(eng, "main", card.cfg.vocab_size)
    assert set(eng.capture_seconds) == {
        "steps_warmup", "steps_capture", "reconfigure_warmup",
        "reconfigure_capture"}
    warm, counts = outputs(eng, "main", card.cfg.vocab_size)
    assert eng.capture_seconds == {}
    assert warm == cold
    assert counts["lookahead_greedy"] == warm["reconfigs"] == \
        cold_counts["lookahead_greedy"] - 1
    assert counts["serve_graph"] == warm["intervals"]


def test_greedy_on_the_first_boundary_equals_plain(models):
    from repro_torch.core import cache_controller
    from repro_torch.kernels.lookahead_greedy import (
        lookahead_greedy,
        lookahead_greedy_plain,
    )

    _, card = models
    got = {}
    real = cache_controller.lookahead_greedy

    def keep(*args, total_units):
        if "args" not in got:       # the reconfiguration's warm-up
            got["args"] = tuple(a.clone() for a in args)
        return real(*args, total_units=total_units)

    cache_controller.lookahead_greedy = keep
    try:
        engine(card, "main", "graph1").run(
            FIXTURES["main"][2](Request, card.cfg.vocab_size),
            max_steps=MAX_STEPS)
    finally:
        cache_controller.lookahead_greedy = real
    args = got["args"]
    U = FIXTURES["main"][1].total_pages
    alloc, bal = lookahead_greedy(*args, total_units=U)
    alloc_p, bal_p = lookahead_greedy_plain(*args, total_units=U)
    assert torch.equal(alloc, alloc_p) and torch.equal(bal, bal_p)


def test_a_failed_capture_raises(models, monkeypatch):
    """A host read inside the interval program fails its capture; the
    engine raises instead of running the interval eagerly."""
    _, card = models
    eng = engine(card, "main", "graph1")
    real = eng._one_step

    def reads_the_host(run):
        real(run)
        bool(run.q["active"].any())

    monkeypatch.setattr(eng, "_one_step", reads_the_host)
    with pytest.raises(RuntimeError):
        eng.run(FIXTURES["main"][2](Request, card.cfg.vocab_size),
                max_steps=MAX_STEPS)
