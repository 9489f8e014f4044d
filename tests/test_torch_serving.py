"""The port's serving path (``repro_torch.serving``) against the JAX
package's engines on the CPU, on the same parameters.

The reference (``tests/_torch_serving_ref.py``) runs in one
module-scoped subprocess with x64 off, as ``tests/test_serving_jax.py``
runs it, over that test's own fixtures: ``ECFG`` with ``_requests(vocab,
n=14, n_streams=4, seed=3)`` at one and two groups, the staggered
admissions (seed 11), the one-slot queue-wait and tie-break configs, and
CBP off.  Its ``configs.get_smoke("qwen3-8b")`` parameters
(``PRNGKey(0)``) pass through ``params_from_jax``.

* The port's host ``ServingEngine`` equals the reference's: steps,
  reconfigurations, queue wait, slot shares, the pool's partition, every
  ``StreamStats`` field, occupancy and readahead exactly.
* ``GraphServingEngine`` (run eagerly on the CPU) equals
  ``JitServingEngine``: steps, reconfigurations, intervals, partition,
  readahead, occupancy, evictions, the demand and prefetch hit/miss
  counts and tokens done exactly; slot shares and queue wait within
  :data:`F32_RTOL` (float32; the inputs are dyadic, so the distance is
  0 where measured); one ``serve_graph`` run an interval, one
  ``serve_reconfig`` run a reconfiguration.
* Tokens follow the token rule (``_torch_serving_ref.token_rule``): equal
  to the reference's, or equal up to a step where the reference's own
  top-2 logit gap is at most 1e-5 + 1e-4 |top logit| (the model
  tests' tolerance), not compared from there on.

The port's own contracts: on the MoE, SSM, hybrid and VLM smoke models
the host and device engines give identical tokens and schedules; a
second run of the same request shape reuses the engine's static state
and repeats the first; ``encdec`` is refused; groups must divide streams,
slots and pages.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_serving_ref import (
    ARCH,
    MAX_STEPS,
    fixtures,
    requests_main,
    serving_reference,
    token_rule,
)

from repro_torch import configs
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.models import build, params_from_jax
from repro_torch.serving import (
    EngineConfig,
    GraphServingEngine,
    Request,
    ServingEngine,
)

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread runs their small ops
    fastest, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: float32 slot shares and queue wait of the device engines.
F32_RTOL = 1e-6

FIXTURES = fixtures(EngineConfig)
HOST_CASES = list(FIXTURES)
GRAPH_CASES = [(name, g) for name, spec in FIXTURES.items()
               for g in spec[3]]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return serving_reference(tmp_path_factory)


@pytest.fixture(scope="module")
def model(ref):
    return params_from_jax(configs.get_smoke(ARCH), ref["params"],
                           device="cpu")


def run_host(model, name):
    n, ecfg, make, _ = FIXTURES[name]
    eng = ServingEngine(model, n, ecfg, device="cpu")
    reqs = make(Request, model.cfg.vocab_size)
    eng.run(reqs, max_steps=MAX_STEPS)
    return eng, reqs


def run_graph(model, name, groups):
    n, ecfg, make, _ = FIXTURES[name]
    eng = GraphServingEngine(model, n, ecfg, n_groups=groups,
                             device="cpu")
    reqs = make(Request, model.cfg.vocab_size)
    reset_launch_counts()
    eng.run(reqs, max_steps=MAX_STEPS)
    return eng, reqs, launch_counts()


def assert_tokens(reqs, want, margins, what):
    """The token rule over every request; returns how many it excused
    (recorded as the test's ``excused_requests`` property)."""
    verdicts = [token_rule(r.generated, w, m)
                for r, w, m in zip(reqs, want, margins)]
    assert "differ" not in verdicts, (what, verdicts)
    return verdicts.count("excused")


@pytest.mark.parametrize("name", HOST_CASES)
def test_host_engine_matches_reference(name, ref, model, record_property):
    want = ref["runs"][f"{name}/host"]
    eng, reqs = run_host(model, name)
    assert (eng.steps, eng.reconfigs) == (want["steps"], want["reconfigs"])
    for key in ("queue_wait", "slot_share", "tokens_done", "readahead"):
        np.testing.assert_array_equal(getattr(eng, key), want[key],
                                      err_msg=key)
    np.testing.assert_array_equal(eng.pool.partition, want["partition"])
    assert eng.pool.partition.dtype == np.int64
    np.testing.assert_array_equal(eng.pool.occupancy(), want["occupancy"])
    assert [[s.hits, s.misses, s.evictions, s.prefetch_hits,
             s.prefetch_misses] for s in eng.pool.stats] == want["stats"]
    record_property("excused_requests", assert_tokens(
        reqs, want["tokens"], want["margins"], name))


@pytest.mark.parametrize("name,groups", GRAPH_CASES)
def test_graph_engine_matches_jit_engine(name, groups, ref, model,
                                         record_property):
    want = ref["runs"][f"{name}/jit{groups}"]
    eng, reqs, counts = run_graph(model, name, groups)
    for key in ("steps", "reconfigs", "intervals"):
        assert getattr(eng, key) == want[key], key
    for key in ("partition", "readahead", "occupancy", "evictions",
                "demand_hits", "demand_misses", "prefetch_hits",
                "prefetch_misses", "tokens_done"):
        np.testing.assert_array_equal(getattr(eng, key), want[key],
                                      err_msg=key)
    for key in ("slot_share", "queue_wait"):
        np.testing.assert_allclose(getattr(eng, key), want[key],
                                   rtol=F32_RTOL, atol=0, err_msg=key)
    # the reference's one dispatch an interval
    assert counts["serve_graph"] == eng.intervals == want["dispatches"]
    assert counts["serve_reconfig"] == eng.reconfigs
    # tokens: the reference's host engine runs the same schedule at one
    # group, and its margins are the reference model's own
    host = ref["runs"][f"{name}/host"]
    record_property("excused_requests", assert_tokens(
        reqs, want["tokens"], host["margins"], name))


def test_fixtures_are_the_reference_tests():
    """The helper's fixtures are ``tests/test_serving_jax.py``'s."""
    import test_serving_jax as t

    vocab = configs.get_smoke(ARCH).vocab_size
    ours, theirs = requests_main(Request, vocab), t._requests(vocab)
    assert [(r.stream, r.prompt.tolist(), r.max_new_tokens) for r in ours] \
        == [(r.stream, r.prompt.tolist(), r.max_new_tokens) for r in theirs]
    assert dataclasses.asdict(FIXTURES["main"][1]) == \
        dataclasses.asdict(t.ECFG)


# ------------------------------------------------------------------ #
# the port's own contracts
# ------------------------------------------------------------------ #

OTHER_ARCHS = ("qwen3-moe-30b-a3b", "mamba2-1.3b", "zamba2-7b",
               "pixtral-12b")


def schedule(eng, reqs):
    return (eng.steps, eng.reconfigs, list(eng.queue_wait),
            list(eng.tokens_done), [r.generated for r in reqs])


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_host_and_graph_engines_agree(arch):
    """Tokens, steps, reconfigurations, queue wait and tokens done equal;
    slot shares within the float32 bound."""
    model = build(configs.get_smoke(arch), device="cpu", seed=0)
    n, ecfg, make, _ = FIXTURES["main"]
    host = ServingEngine(model, n, ecfg, device="cpu")
    h_reqs = make(Request, model.cfg.vocab_size)
    host.run(h_reqs, max_steps=MAX_STEPS)
    graph = GraphServingEngine(model, n, ecfg, device="cpu")
    g_reqs = make(Request, model.cfg.vocab_size)
    graph.run(g_reqs, max_steps=MAX_STEPS)
    assert schedule(graph, g_reqs) == schedule(host, h_reqs)
    np.testing.assert_allclose(graph.slot_share, host.slot_share,
                               rtol=F32_RTOL, atol=0)
    assert all(len(r.generated) == r.max_new_tokens for r in g_reqs)


def test_second_run_of_a_shape_repeats_the_first(model):
    """The static state is refilled, not carried over: the same requests
    again give the same outputs, through the same state tensors."""
    n, ecfg, make, _ = FIXTURES["main"]
    eng = GraphServingEngine(model, n, ecfg, device="cpu")
    first = make(Request, model.cfg.vocab_size)
    eng.run(first, max_steps=MAX_STEPS)
    before = (schedule(eng, first), eng.partition.tolist(),
              eng.demand_hits.tolist(), eng.idle_steps)
    state = {k: v.data_ptr() for k, v in next(iter(
        eng._runs.values())).q.items()}
    again = make(Request, model.cfg.vocab_size)
    eng.run(again, max_steps=MAX_STEPS)
    assert len(eng._runs) == 1
    assert {k: v.data_ptr() for k, v in next(iter(
        eng._runs.values())).q.items()} == state
    assert (schedule(eng, again), eng.partition.tolist(),
            eng.demand_hits.tolist(), eng.idle_steps) == before


def test_max_steps_stops_every_engine_alike(model):
    """``max_steps`` cuts both engines at the same step, mid-interval."""
    n, ecfg, make, _ = FIXTURES["main"]
    host = ServingEngine(model, n, ecfg, device="cpu")
    h_reqs = make(Request, model.cfg.vocab_size)
    host.run(h_reqs, max_steps=13)
    graph = GraphServingEngine(model, n, ecfg, device="cpu")
    g_reqs = make(Request, model.cfg.vocab_size)
    graph.run(g_reqs, max_steps=13)
    assert graph.steps == host.steps == 13
    assert graph.intervals == 2 and graph.reconfigs == host.reconfigs == 1
    assert [r.generated for r in g_reqs] == [r.generated for r in h_reqs]


def test_engines_run_where_their_model_is(model):
    """An engine's device is its model's: a CPU model behind an engine
    asked for another device is refused (no copy, no fallback)."""
    for cls in (ServingEngine, GraphServingEngine):
        with pytest.raises(ValueError, match="model is on cpu"):
            cls(model, 4, FIXTURES["main"][1], device="meta")


def test_encdec_is_refused():
    model = build(configs.get_smoke("whisper-tiny"), device="cpu", seed=0)
    with pytest.raises(ValueError, match="enc_len"):
        GraphServingEngine(model, 4, FIXTURES["main"][1], device="cpu")


@pytest.mark.parametrize("n_streams,groups,field", [
    (3, 2, "n_streams"), (4, 3, "n_streams"), (6, 3, "batch_slots")])
def test_group_divisibility_validated(model, n_streams, groups, field):
    with pytest.raises(ValueError, match=f"{field}=.* not divisible"):
        GraphServingEngine(model, n_streams, FIXTURES["main"][1],
                           n_groups=groups, device="cpu")
