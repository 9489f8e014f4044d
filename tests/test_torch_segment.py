"""The sweep's segment backend and the timeline's length buckets.

Segment against stacked, the reference's contract
(``tests/test_timeline_fused.py``): for every manager, cache units and
prefetch settings equal, IPC within 1e-9 relative and bandwidth within
rtol 1e-12; also when ``total_ms`` is an exact multiple of the interval,
so CPpf's last reallocation rides the trailing zero-duration slot, and
with the decay constants swept through ``param_grid``.  The host
allocator (``allocator_backend="numpy"``) implies the segment backend and
is the only path that calls it.  The bucketed timeline is bit-identical
to the single stacked table.
"""
import numpy as np
import pytest

from repro_torch.core import cache_controller_numpy
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.core.types import CBPParams, ScheduleSegment
from repro_torch.sim import (
    MANAGER_NAMES,
    WORKLOADS,
    BatchedCMPPlant,
    CMPConfig,
    policies,
    random_mixes,
    run_sweep,
)
from repro_torch.sim import timeline
from repro_torch.sim.sweep import _manager_spec
from repro_torch.sim.timeline import (
    RUN,
    _length_buckets,
    cppf_schedule,
    run_timelines,
    segment_table,
    stack_tables,
)

SEGMENT = CMPConfig(timeline_backend="segment")
MIXES = [WORKLOADS["w1"], WORKLOADS["w2"]]


def assert_contract(stacked, seg, names, what=""):
    for name in names:
        a, b = stacked.final_alloc[name], seg.final_alloc[name]
        np.testing.assert_array_equal(a.cache_units, b.cache_units,
                                      err_msg=f"{what}{name}")
        np.testing.assert_array_equal(a.prefetch_on, b.prefetch_on,
                                      err_msg=f"{what}{name}")
        np.testing.assert_allclose(stacked.ipc[name], seg.ipc[name],
                                   rtol=1e-9, atol=0, err_msg=f"{what}{name}")
        np.testing.assert_allclose(a.bandwidth, b.bandwidth, rtol=1e-12,
                                   err_msg=f"{what}{name}")


@pytest.fixture(scope="module")
def runs():
    return (run_sweep(MIXES, total_ms=40.0, device="cpu"),
            run_sweep(MIXES, total_ms=40.0, device="cpu", config=SEGMENT))


@pytest.mark.parametrize("name", MANAGER_NAMES)
def test_segment_matches_stacked_every_manager(runs, name):
    assert_contract(*runs, [name])


def test_segment_baseline_and_shapes(runs):
    stacked, seg = runs
    np.testing.assert_array_equal(stacked.baseline_ipc, seg.baseline_ipc)
    for name in MANAGER_NAMES:
        assert seg.ipc[name].shape == (2, 16)
        assert isinstance(seg.final_alloc[name].cache_units, np.ndarray)


def test_trailing_boundary_realloc_fires_on_exact_multiple_total_ms():
    """20 ms is two intervals: CPpf's final reallocation is the trailing
    zero-duration slot of the stacked table and the end of the segment
    loop."""
    p = CBPParams()
    assert (20.0 / p.reconfiguration_interval_ms) % 1.0 == 0.0
    kinds, _dur, reconf = segment_table(cppf_schedule(20.0, p))
    assert bool(reconf[-1])
    names = ["CPpf", "CBP"]
    stacked = run_sweep(MIXES, managers=names, total_ms=20.0, device="cpu")
    seg = run_sweep(MIXES, managers=names, total_ms=20.0, device="cpu",
                    config=SEGMENT)
    assert_contract(stacked, seg, names)


def test_decay_constants_sweep_through_param_grid_on_both_backends():
    grid = [CBPParams(), CBPParams(atd_decay=0.9, bandwidth_delay_decay=0.2)]
    out = {}
    for label, cfg in (("stacked", None), ("segment", SEGMENT)):
        res = run_sweep(MIXES[:1], managers=["CBP"], total_ms=30.0,
                        param_grid=grid, device="cpu", config=cfg)
        assert res.ipc["CBP"].shape == (2, 1, 16)
        for pi, p in enumerate(grid):
            one = run_sweep(MIXES[:1], managers=["CBP"], total_ms=30.0,
                            params=p, device="cpu", config=cfg)
            np.testing.assert_array_equal(res.ipc["CBP"][pi], one.ipc["CBP"])
        assert not np.array_equal(res.ipc["CBP"][0], res.ipc["CBP"][1])
        out[label] = res
    assert_contract(out["stacked"], out["segment"], ["CBP"])


def test_numpy_allocator_implies_segment_and_calls_the_host_golden():
    cfg = CMPConfig(allocator_backend="numpy")
    plant = BatchedCMPPlant(MIXES, cfg, device="cpu")
    assert plant.allocator_backend == "numpy"
    assert plant.timeline_backend == "segment"
    names = ["only cache", "CPpf", "CBP"]
    cache_controller_numpy.reset_allocator_calls()
    host = run_sweep(MIXES, managers=names, total_ms=20.0, config=cfg,
                     device="cpu")
    # one host greedy per mix per Lookahead boundary: only cache and CBP
    # reallocate once in 20 ms, CPpf twice (its trailing boundary too);
    # CPpf's host golden also runs per mix.
    assert cache_controller_numpy.allocator_calls() == 2 * (1 + 1 + 2)
    cache_controller_numpy.reset_allocator_calls()
    reset_launch_counts()
    dev = run_sweep(MIXES, managers=names, total_ms=20.0, device="cpu")
    seg = run_sweep(MIXES, managers=names, total_ms=20.0, device="cpu",
                    config=SEGMENT)
    assert cache_controller_numpy.allocator_calls() == 0
    assert launch_counts()["lookahead_greedy"] == 0       # CPU: plain version
    assert_contract(dev, host, names, "numpy vs stacked: ")
    for name in names:
        np.testing.assert_array_equal(host.ipc[name], seg.ipc[name])


def test_backend_names_are_checked():
    with pytest.raises(ValueError, match="timeline backend"):
        run_sweep(MIXES, device="cpu",
                  config=CMPConfig(timeline_backend="scan"))
    with pytest.raises(ValueError, match="allocator backend"):
        run_sweep(MIXES, device="cpu",
                  config=CMPConfig(allocator_backend="host"))


def test_length_buckets_group_exact_length():
    """The reference's rule and cases: a bucket holds exactly the managers
    with the same table length, in spec order."""
    assert _length_buckets([1, 1, 30, 10, 13, 30]) == [[0, 1], [3], [4],
                                                       [2, 5]]
    assert _length_buckets([5]) == [[0]]
    for lens in ([1, 2, 3, 4], [7, 7, 7], [1, 100], [3, 9, 27]):
        buckets = _length_buckets(lens)
        assert sorted(i for b in buckets for i in b) == list(
            range(len(lens)))
        for b in buckets:
            assert len({lens[i] for i in b}) == 1


def test_table3_buckets_and_greedy_boundaries():
    """At 100 ms the 14 managers fall into four buckets (1, 10, 13 and 30
    slots); their Lookahead managers reallocate at 9, 10 and 9 slots of
    their buckets, 17 distinct slots of the shared loop (one greedy launch
    each), where one table reallocates at 10."""
    plant = BatchedCMPPlant(random_mixes(1, 16, seed=1), device="cpu")
    specs = [_manager_spec(plant, name, 100.0, CBPParams())
             for name in MANAGER_NAMES]
    lens = [len(segment_table(s.schedule)[0]) for s in specs]
    buckets = _length_buckets(lens)
    assert sorted({lens[b[0]] for b in buckets}) == [1, 10, 13, 30]
    assert [MANAGER_NAMES[i] for i in buckets[0]] == [
        "baseline", "equal off", "equal on"]

    def greedy_slots(idx):
        kinds, _acc, reconf = stack_tables(
            [segment_table(specs[i].schedule) for i in idx],
            [RUN if specs[i].variant == "cppf" else None for i in idx])
        look = np.array([specs[i].cache_dynamic and specs[i].cache_policy
                         == policies.CACHE_LOOKAHEAD for i in idx])
        return set(np.flatnonzero((reconf & look[:, None]).any(axis=0)))

    per_bucket = [greedy_slots(b) for b in buckets]
    assert [len(slots) for slots in per_bucket] == [0, 9, 10, 9]
    assert len(set().union(*per_bucket)) == 17
    assert len(greedy_slots(range(len(specs)))) == 10


def one_table(monkeypatch):
    """Stack every manager into one table: the reference the buckets are
    held to."""
    monkeypatch.setattr(timeline, "_length_buckets",
                        lambda lens: [list(range(len(lens)))])


@pytest.mark.parametrize("total_ms", [20.0, 37.5])
def test_buckets_bit_identical_to_one_table(total_ms, monkeypatch):
    mixes = random_mixes(3, 16, seed=4)
    a = run_sweep(mixes, total_ms=total_ms, device="cpu")
    one_table(monkeypatch)
    b = run_sweep(mixes, total_ms=total_ms, device="cpu")
    for name in MANAGER_NAMES:
        np.testing.assert_array_equal(a.ipc[name], b.ipc[name],
                                      err_msg=name)
        for f in ("cache_units", "bandwidth", "prefetch_on"):
            np.testing.assert_array_equal(getattr(a.final_alloc[name], f),
                                          getattr(b.final_alloc[name], f),
                                          err_msg=f"{name} {f}")


def test_run_timelines_buckets_with_per_mix_tunables(monkeypatch):
    """Per-mix tunables given with trailing singleton axes (the segment
    path's (M, 1) and (M, 1, 1)) run the same in buckets and in one
    table."""
    plant = BatchedCMPPlant(random_mixes(2, 16, seed=2), device="cpu")
    specs = [_manager_spec(plant, name, 20.0, CBPParams())
             for name in ("equal on", "only cache", "CPpf", "CBP", "qos")]
    kw = dict(total_units=256, total_bandwidth=64.0,
              min_ways=np.array([3, 5]),
              speedup_threshold=np.array([[1.02], [1.1]]),
              min_bandwidth_allocation=np.array([[0.5], [2.0]]),
              atd_decay=np.array([[[0.3]], [[0.8]]]),
              bandwidth_delay_decay=np.array([[0.6], [0.1]]))
    a = run_timelines(plant.params, specs, **kw)
    one_table(monkeypatch)
    b = run_timelines(plant.params, specs, **kw)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.ipc_acc, rb.ipc_acc)
        np.testing.assert_array_equal(ra.cache_units, rb.cache_units)
        np.testing.assert_array_equal(ra.bandwidth, rb.bandwidth)
        assert ra.w_acc == rb.w_acc
    assert a[0].w_acc == 20.0 and len(specs[0].schedule) == 1
    assert specs[0].schedule[0] == ScheduleSegment("run", 20.0)


@pytest.mark.parametrize("pf_mode", ["DYNAMIC", "ON"])
def test_batched_coordinator_fused_equals_segment(pf_mode):
    """BatchedCoordinator runs the same Fig. 8 timeline as one stacked
    timeline (a stacked plant) or as the segment loop, under the contract,
    with per-row params."""
    from repro_torch.core.types import Mode, PrefetchMode
    from repro_torch.sim.sweep import BatchedCoordinator

    rows = [CBPParams(min_ways=3, atd_decay=0.6), CBPParams(min_ways=5)]
    out = {}
    for backend in ("stacked", "segment"):
        plant = BatchedCMPPlant(MIXES, CMPConfig(timeline_backend=backend),
                                device="cpu")
        coord = BatchedCoordinator(
            plant, cache_mode=Mode.DYNAMIC, bandwidth_mode=Mode.DYNAMIC,
            prefetch_mode=PrefetchMode[pf_mode], params_rows=rows)
        coord.run(20.0)
        out[backend] = coord
    a, b = out["stacked"], out["segment"]
    np.testing.assert_array_equal(a.alloc.cache_units.numpy(),
                                  b.alloc.cache_units.numpy())
    np.testing.assert_array_equal(a.alloc.prefetch_on.numpy(),
                                  b.alloc.prefetch_on.numpy())
    np.testing.assert_allclose(a.mean_ipc(), b.mean_ipc(),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(a.alloc.bandwidth.numpy(),
                               b.alloc.bandwidth.numpy(), rtol=1e-12)
    assert (a.alloc.cache_units.numpy() >= np.array([[3], [5]])).all()
