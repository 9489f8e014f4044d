"""Row and grid sharding of the port (``repro_torch.distributed``) on the
CPU, held to the JAX package's ``repro.distributed`` and to the port's
own unsharded runs.

* The shard counts equal the reference's, computed on 8 and 7 forced host
  devices in module-scoped subprocesses (``tests/_torch_distributed_ref.
  py``), for every ``K, M`` in 1..11 and ``n_rows`` in 0..32; the
  reference's literal cases (``tests/test_timeline_fused.py``'s
  ``_CLAMP_SCRIPT`` and ``_PRIME_SCRIPT``) hold too.
* ``run_sweep`` under ``use_devices([cpu] * 8)`` (all 14 managers over
  w1 and w2, 20 ms: a (4, 2) grid, managers padded 14 -> 16) and
  ``[cpu] * 7`` (only cache, CPpf and CBP: (3, 2) on 6 of 7) equals the
  unsharded run bit for bit, as ``tests/test_timeline_fused.py:297`` and
  ``:391`` hold the reference's; so do ``run_timeline`` against the
  ``K = 1`` ``run_timelines``, a small ``run_stream`` on 3 devices, and
  ``search_static`` on 8 (``tests/test_static_search.py:538``).
* A device list of another type than the parameters' raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_distributed_ref as ref

from repro_torch import distributed
from repro_torch.core.types import CBPParams
from repro_torch.sim import (
    MANAGER_NAMES,
    WORKLOADS,
    StreamConfig,
    random_mixes,
    random_workloads,
    run_stream,
    run_sweep,
    search_static,
)
from repro_torch.sim import timeline
from repro_torch.sim.sweep import BatchedCMPPlant, _manager_spec

CPU = torch.device("cpu")
PRIME_NAMES = ["only cache", "CPpf", "CBP"]


def cpus(n: int):
    return distributed.use_devices([CPU] * n)


@pytest.fixture(scope="module")
def reference_counts():
    return ref.reference((8, 7))


@pytest.fixture(scope="module")
def unsharded_sweep():
    return run_sweep([WORKLOADS["w1"], WORKLOADS["w2"]], total_ms=20.0,
                     device="cpu")


def assert_same_sweep(got, want, names):
    for name in names:
        np.testing.assert_array_equal(got.ipc[name], want.ipc[name],
                                      err_msg=name)
        for field in ("cache_units", "bandwidth", "prefetch_on"):
            np.testing.assert_array_equal(
                getattr(got.final_alloc[name], field),
                getattr(want.final_alloc[name], field),
                err_msg=f"{name} {field}")


# --------------------------------------------------------------------- #
# shard counts
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("n_devices", [8, 7])
def test_shard_counts_equal_the_reference(reference_counts, n_devices):
    want = reference_counts[n_devices]
    assert want["devices"] == n_devices
    with cpus(n_devices):
        assert [distributed.row_shard_count(n) for n in ref.ROWS] \
            == want["row"]
        assert [[K, M, *distributed.grid_shard_counts(K, M)]
                for K in ref.GROUPS for M in ref.GROUPS] == want["grid"]


def test_reference_clamp_cases():
    """``_CLAMP_SCRIPT`` (``tests/test_timeline_fused.py:318``)."""
    with cpus(8):
        assert distributed.row_shard_count(3) == 3
        assert distributed.row_shard_count(100) == 8
        assert distributed.row_shard_count(0) == 1
        for n_rows in range(1, 33):
            s = distributed.row_shard_count(n_rows)
            pad = -(-n_rows // s) * s - n_rows
            assert s <= n_rows and pad < n_rows, (n_rows, s, pad)
        assert distributed.grid_shard_counts(1, 3) == (1, 3)
        assert distributed.grid_shard_counts(2, 2) == (2, 2)
        assert distributed.grid_shard_counts(11, 32) == (2, 4)
        res = run_sweep(random_mixes(3, 16, seed=2), managers=["CBP"],
                        total_ms=20.0, device="cpu")
    assert np.isfinite(res.ipc["CBP"]).all()


def test_reference_prime_cases():
    """``_PRIME_SCRIPT`` (``tests/test_timeline_fused.py:357``)."""
    with cpus(7):
        assert distributed.grid_shard_counts(3, 2) == (3, 2)
        assert distributed.grid_shard_counts(7, 1) == (7, 1)
        assert distributed.grid_shard_counts(1, 7) == (1, 7)
        for K in range(1, 12):
            for M in range(1, 12):
                a, b = distributed.grid_shard_counts(K, M)
                assert 1 <= a <= K and 1 <= b <= M and a * b <= 7
                assert -(-K // a) * a - K < a and -(-M // b) * b - M < b


def test_one_device_gives_one_shard():
    """The default list on the CPU is ``[cpu]``: every caller skips the
    split, as on one card."""
    assert distributed.device_list("cpu") == [CPU]
    assert distributed.grid_shard_counts(14, 4096, "cpu") == (1, 1)
    assert distributed.row_shard_count(640, "cpu") == 1


# --------------------------------------------------------------------- #
# the split itself
# --------------------------------------------------------------------- #

def test_shard_grid_blocks_and_gather_order():
    """Each (group, row) block sees its own rows, its group's leaves and
    the replicated tree, and the outputs gather in grid order."""
    K, M = 4, 6
    grid = {"x": torch.arange(K * M, dtype=torch.float64).reshape(K, M)}
    seen = []

    def worker(g, grp, rep):
        seen.append((g["x"].shape, grp["names"], rep["c"]))
        return {"y": g["x"] * rep["c"] + grp["k"][:, None]}

    with cpus(6):
        out = distributed.shard_grid(worker, (2, 3), gather_to=CPU)(
            grid, {"k": torch.arange(K, dtype=torch.float64),
                   "names": ["a", "b", "c", "d"]}, {"c": 2.0})
    torch.testing.assert_close(
        out["y"], grid["x"] * 2.0 + torch.arange(K)[:, None], rtol=0,
        atol=0)
    assert seen == [((2, 2), ["a", "b"], 2.0)] * 3 \
        + [((2, 2), ["c", "d"], 2.0)] * 3


def test_shard_rows_refuses_unequal_blocks_and_short_lists():
    fn = distributed.shard_rows(lambda s, r: s, 3, gather_to=CPU)
    with cpus(3):
        with pytest.raises(ValueError, match="equal"):
            fn({"x": torch.zeros(4, 2)}, {})
        out = fn({"x": torch.arange(6.0)}, {})
    torch.testing.assert_close(out["x"], torch.arange(6.0))
    with cpus(2), pytest.raises(ValueError, match="3 shards need"):
        fn({"x": torch.arange(6.0)}, {})


@pytest.mark.parametrize("kind", ["cuda:0", "meta"])
def test_device_of_another_type_raises(kind):
    """A list of cards (or of another type) for parameters on the CPU
    raises before any work: no block runs on another device."""
    meta = [torch.device(kind)] * 2
    with distributed.use_devices(meta):
        with pytest.raises(ValueError, match="not of the parameters"):
            distributed.device_list("cpu")
        with pytest.raises(ValueError, match="not of the parameters"):
            run_sweep(random_mixes(2, 16, seed=1), managers=["CBP"],
                      total_ms=5.0, device="cpu")
        with pytest.raises(ValueError, match="not of the parameters"):
            search_static(random_workloads(3, 3, seed=4), k=2,
                          device="cpu")
        fn = distributed.shard_rows(lambda s, r: s, 2, gather_to=CPU)
        with pytest.raises(ValueError, match="not of the parameters"):
            fn({"x": torch.zeros(4)}, {})
    with pytest.raises(ValueError):
        with distributed.use_devices([]):
            pass


# --------------------------------------------------------------------- #
# the sharded paths against their unsharded runs
# --------------------------------------------------------------------- #

def test_sweep_on_8_devices_equals_unsharded(unsharded_sweep):
    """All 14 managers (auction, qos and bank bw included) on a (4, 2)
    grid, managers padded 14 -> 16."""
    with cpus(8):
        assert distributed.grid_shard_counts(14, 2) == (4, 2)
        got = run_sweep([WORKLOADS["w1"], WORKLOADS["w2"]], total_ms=20.0,
                        device="cpu")
    assert list(got.manager_names) == list(MANAGER_NAMES)
    assert_same_sweep(got, unsharded_sweep, MANAGER_NAMES)
    np.testing.assert_array_equal(got.baseline_ipc,
                                  unsharded_sweep.baseline_ipc)


def test_sweep_on_7_devices_equals_unsharded(unsharded_sweep):
    with cpus(7):
        got = run_sweep([WORKLOADS["w1"], WORKLOADS["w2"]],
                        managers=PRIME_NAMES, total_ms=20.0, device="cpu")
    assert_same_sweep(got, unsharded_sweep, PRIME_NAMES)


def test_sweep_shard_false_runs_unsharded(unsharded_sweep, monkeypatch):
    """``shard=False`` never splits, whatever the device list."""
    plant = BatchedCMPPlant([WORKLOADS["w1"], WORKLOADS["w2"]],
                            device="cpu")
    spec = _manager_spec(plant, "CBP", 20.0, CBPParams())
    monkeypatch.setattr(distributed, "shard_grid", None)
    with cpus(8):
        res = timeline.run_timelines(
            plant.params, [spec], total_units=plant.total_cache_units,
            total_bandwidth=plant.total_bandwidth, shard=False)[0]
    np.testing.assert_array_equal(
        res.cache_units, unsharded_sweep.final_alloc["CBP"].cache_units)


@pytest.mark.parametrize("n_devices", [1, 3])
def test_run_timeline_equals_run_timelines(n_devices):
    mixes = random_mixes(5, 16, seed=3)
    plant = BatchedCMPPlant(mixes, device="cpu")
    spec = _manager_spec(plant, "CPpf", 20.0, CBPParams())
    kw = dict(total_units=plant.total_cache_units,
              total_bandwidth=plant.total_bandwidth, min_ways=4,
              speedup_threshold=1.05)
    want = timeline.run_timelines(plant.params, [spec], shard=False,
                                  **kw)[0]
    with cpus(n_devices):
        got = timeline.run_timeline(
            plant.params, spec.schedule, variant=spec.variant,
            init_units=spec.init_units, init_bandwidth=spec.init_bandwidth,
            init_prefetch=spec.init_prefetch,
            cache_dynamic=spec.cache_dynamic,
            bandwidth_dynamic=spec.bandwidth_dynamic,
            cache_partitioned=spec.cache_partitioned,
            bandwidth_partitioned=spec.bandwidth_partitioned, **kw)
    for field in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, field.name),
                                      getattr(want, field.name),
                                      err_msg=field.name)


def test_stream_on_3_devices_equals_unsharded():
    cfg = StreamConfig(n_mixes=24, chunk_size=8, managers=("baseline", "CBP"),
                       total_ms=10.0, seed=11)
    want = run_stream(cfg, device="cpu")
    with cpus(3):
        got = run_stream(cfg, device="cpu")
    tw, tg = want.aggregates.to_tree(), got.aggregates.to_tree()
    assert tw.keys() == tg.keys()
    for key in tw:
        np.testing.assert_array_equal(tg[key], tw[key], err_msg=key)
    assert got.geomean_ws == want.geomean_ws
    assert got.coverage == want.coverage == 1.0


@pytest.mark.parametrize("stack_families", [True, False])
def test_search_on_8_devices_equals_unsharded(stack_families):
    """``tests/test_static_search.py:538``'s case: 3 workloads on 8
    devices shard 3 ways."""
    wls = random_workloads(3, 3, seed=4)
    want = search_static(wls, k=2, device="cpu")
    with cpus(8):
        assert distributed.row_shard_count(3) == 3
        got = search_static(wls, k=2, device="cpu",
                            stack_families=stack_families)
    for name in want.family_names:
        np.testing.assert_array_equal(got.topk_index[name],
                                      want.topk_index[name], err_msg=name)
        np.testing.assert_array_equal(got.topk_ws[name], want.topk_ws[name],
                                      err_msg=name)
    np.testing.assert_array_equal(got.baseline_ipc, want.baseline_ipc)


def test_search_pads_workloads_and_keeps_global_chunks(monkeypatch):
    """5 workloads on 2 devices pad to 6; every block scans the chunks of
    the padded global count (5 unsharded: other chunks, the same picks,
    since a tie goes to the lowest index in any chunking), and the Pareto
    fold gathers too."""
    from repro_torch.sim import static_search

    seen = []
    real = static_search._family_tables

    def spy(grid, w_pad, k, chunk_elements):
        seen.append(w_pad)
        return real(grid, w_pad, k, chunk_elements)

    wls = random_workloads(5, 3, seed=2)
    want = search_static(wls, k=3, device="cpu", multi_objective=True,
                         chunk_elements=600)
    monkeypatch.setattr(static_search, "_family_tables", spy)
    with cpus(2):
        got = search_static(wls, k=3, device="cpu", multi_objective=True,
                            chunk_elements=600)
    assert set(seen) == {6}
    for name in want.family_names:
        np.testing.assert_array_equal(got.topk_index[name],
                                      want.topk_index[name], err_msg=name)
        for field in ("topk_ws", "topk_fairness"):
            np.testing.assert_array_equal(getattr(got, field)[name],
                                          getattr(want, field)[name],
                                          err_msg=name)
