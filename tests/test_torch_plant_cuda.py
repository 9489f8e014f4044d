"""The training-loop binding on the card: the fused Fig. 8 knob schedule
as one CUDA-graph replay per run, bit-identical to the reference's golden
(``tests/data/plant_golden.json``), and the host golden
(``host_reference_run``) within its tolerance.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_*.py``.  The file imports neither JAX nor the JAX
package.
"""
import numpy as np
import pytest
import torch

from _plant_golden import (
    assert_bit_identical,
    assert_within,
    load,
    plant_model,
    port_kwargs,
)

from repro_torch.core import cache_controller
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.core.types import Mode, PrefetchMode, fig8_schedule
from repro_torch.kernels.lookahead_greedy import (
    lookahead_greedy,
    lookahead_greedy_plain,
)
from repro_torch.runtime import plant
from repro_torch.runtime.plant import host_reference_run, run_fused_schedule
from repro_torch.sim.timeline import segment_table

pytestmark = pytest.mark.cuda

GOLDEN = load()
#: The port's host golden against the reference's (as the CPU test's).
HOST_RTOL = 1e-12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Lookahead greedy kernel and "
                    "CUDA graphs have no CPU mode")


def reconfigurations(name) -> int:
    """Greedy launches one run of ``name`` makes: one per reconfigure row
    of its segment table when the cache is managed."""
    kw = port_kwargs(GOLDEN[name][0])
    if kw["cache_mode"] != Mode.DYNAMIC:
        return 0
    schedule = fig8_schedule(kw["total_ms"], kw["params"],
                             kw["prefetch_mode"] == PrefetchMode.DYNAMIC)
    return int(segment_table(schedule)[2].sum())


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_card_fused_bit_identical_to_golden(card, name):
    args, want = GOLDEN[name]
    _step_fn, step_model = plant_model(args, "cuda")
    got = run_fused_schedule(step_model, **port_kwargs(args))
    assert_bit_identical(got, want, name)


def test_warm_run_is_one_replay(card):
    args, want = GOLDEN["full"]
    _step_fn, step_model = plant_model(args, "cuda")
    kw = port_kwargs(args)
    run_fused_schedule(step_model, **kw)          # warm-up and capture
    for _ in range(3):
        reset_launch_counts()
        got = run_fused_schedule(step_model, **kw)
        counts = launch_counts()
        assert counts["schedule_graph"] == 1, counts
        assert counts["lookahead_greedy"] == reconfigurations("full")
        assert_bit_identical(got, want)


def test_params_sharing_a_schedule_share_one_graph(card):
    args, want = GOLDEN["base"]
    args2, want2 = GOLDEN["base_params2"]
    _step_fn, step_model = plant_model(args, "cuda")
    before = plant._schedule_program.cache_info().currsize
    first = run_fused_schedule(step_model, **port_kwargs(args))
    reset_launch_counts()
    second = run_fused_schedule(step_model, **port_kwargs(args2))
    third = run_fused_schedule(step_model, **port_kwargs(args))
    # Two replays and their captured greedy launches: no second warm-up
    # or capture.
    assert launch_counts()["schedule_graph"] == 2
    assert launch_counts()["lookahead_greedy"] == 2 * reconfigurations(
        "base")
    assert plant._schedule_program.cache_info().currsize == before + 1
    assert_bit_identical(first, want)
    assert_bit_identical(second, want2)
    assert_bit_identical(third, want)
    assert not np.array_equal(first.bandwidth, second.bandwidth)


@pytest.mark.parametrize("name", ["base", "shape_seed7", "full"])
def test_card_host_reference_run_within_tolerance(card, name):
    args, want = GOLDEN[name]
    step_fn, _ = plant_model(args, "cuda")
    reset_launch_counts()
    got = host_reference_run(step_fn, **port_kwargs(args))
    assert launch_counts()["lookahead_greedy"] == reconfigurations(name)
    assert assert_within(got, want, HOST_RTOL, name) <= HOST_RTOL


def test_greedy_kernel_equals_plain_on_the_plants_inputs(card):
    """The first reconfiguration's greedy call of the full shape (B = 1,
    n = 12, U = 96), taken from a fresh run's warm-up."""
    args, _ = GOLDEN["full"]
    calls = []
    real = cache_controller.lookahead_greedy

    def spy(*a, total_units):
        calls.append((tuple(t.clone() for t in a), total_units))
        return real(*a, total_units=total_units)

    _step_fn, step_model = plant_model(args, "cuda")   # a new graph key
    cache_controller.lookahead_greedy = spy
    try:
        run_fused_schedule(step_model, **port_kwargs(args))
    finally:
        cache_controller.lookahead_greedy = real
    (curves, mins, active, rem), U = calls[0]
    assert curves.shape == (1, 12, 97) and U == 96
    alloc, bal = lookahead_greedy(curves, mins, active, rem, total_units=U)
    alloc_p, bal_p = lookahead_greedy_plain(curves, mins, active, rem,
                                            total_units=U)
    assert torch.equal(alloc, alloc_p) and torch.equal(bal, bal_p)


def test_failed_capture_raises_and_does_not_fall_back(card):
    """A model that synchronises cannot be captured: the run raises, no
    replay is counted, and the next run raises again (nothing ran the
    schedule eagerly in its place)."""
    args, _ = GOLDEN["base"]
    _step_fn, good = plant_model(args, "cuda")

    def syncing(dt, units, bw, pf):
        out = good(dt, units, bw, pf)
        bool((out[0] > 0).all())      # a host sync: illegal in a capture
        return out

    reset_launch_counts()
    for _ in range(2):
        with pytest.raises(RuntimeError):
            run_fused_schedule(syncing, **port_kwargs(args))
        torch.cuda.synchronize()
    assert launch_counts()["schedule_graph"] == 0
