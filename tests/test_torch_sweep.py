"""The whole slice: the port's Table-3 sweep against the JAX package.

``run_sweep`` over all 14 managers and ``random_mixes(4, 16, seed=1)`` for
20 ms must give the JAX package's results (float64, subprocess): cache
units and prefetch settings exactly, IPC, bandwidth and geomeans within
rtol 1e-9 (the two differ only in the last bits of ``exp`` and of sums,
and in where XLA fuses a multiply-add).  Within the port, the stacked run
must equal the per-manager ("fused") run bit for bit.  The numpy copies
the port keeps (profiles, workloads, types, schedule) must equal the
reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_jax_ref import SWEEP_MIXES, SWEEP_MS, SWEEP_SEED, jax_reference

from repro.core import coordinator as ref_coordinator
from repro.core import types as ref_types
from repro.sim import apps as ref_apps
from repro.sim import workloads as ref_workloads
from repro_torch.core import types
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.sim import (
    MANAGER_NAMES,
    CMPConfig,
    apps,
    random_mixes,
    run_sweep,
    workloads,
)
from repro_torch.sim.apps import from_numpy
from repro_torch.sim.timeline import segment_table, stack_tables

MIXES = random_mixes(SWEEP_MIXES, 16, seed=SWEEP_SEED)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_reference("sweep", tmp_path_factory)


@pytest.fixture(scope="module")
def stacked():
    return run_sweep(MIXES, total_ms=SWEEP_MS, device="cpu")


@pytest.mark.parametrize("name", MANAGER_NAMES)
def test_sweep_matches_jax_package(jax_ref, stacked, name):
    alloc = stacked.final_alloc[name]
    np.testing.assert_array_equal(alloc.cache_units, jax_ref[f"{name}|units"])
    np.testing.assert_array_equal(alloc.prefetch_on, jax_ref[f"{name}|pf"])
    np.testing.assert_allclose(stacked.ipc[name], jax_ref[f"{name}|ipc"],
                               rtol=1e-9, atol=0.0)
    np.testing.assert_allclose(alloc.bandwidth, jax_ref[f"{name}|bw"],
                               rtol=1e-9, atol=0.0)
    np.testing.assert_allclose(stacked.geomean_speedup(name),
                               jax_ref[f"{name}|geomean"], rtol=1e-9)


def test_baseline_matches_jax_package(jax_ref, stacked):
    np.testing.assert_allclose(stacked.baseline_ipc, jax_ref["baseline_ipc"],
                               rtol=1e-9, atol=0.0)
    assert stacked.summary()["baseline"] == 1.0


def test_stacked_equals_per_manager_bit_for_bit(stacked):
    fused = run_sweep(MIXES, total_ms=SWEEP_MS, device="cpu",
                      config=CMPConfig(timeline_backend="fused"))
    for name in MANAGER_NAMES:
        a, b = stacked.final_alloc[name], fused.final_alloc[name]
        assert np.array_equal(stacked.ipc[name], fused.ipc[name]), name
        assert np.array_equal(a.cache_units, b.cache_units), name
        assert np.array_equal(a.bandwidth, b.bandwidth), name
        assert np.array_equal(a.prefetch_on, b.prefetch_on), name


def test_cpu_sweep_launches_no_kernel():
    reset_launch_counts()
    run_sweep(MIXES[:1], managers=["CBP"], total_ms=SWEEP_MS, device="cpu")
    counts = launch_counts()
    assert "lookahead_greedy" in counts
    assert all(n == 0 for n in counts.values()), counts


def test_unknown_manager_raises():
    with pytest.raises(ValueError, match="unknown manager"):
        run_sweep(MIXES, managers=["CBP", "nope"], device="cpu")


@pytest.mark.parametrize("n_mixes,seed", [(4, 1), (32, 1), (17, 9)])
def test_random_mixes_equal_reference(n_mixes, seed):
    assert (random_mixes(n_mixes, 16, seed=seed)
            == ref_workloads.random_mixes(n_mixes, 16, seed=seed))


def test_workloads_and_profiles_equal_reference():
    assert workloads.WORKLOADS == ref_workloads.WORKLOADS
    assert apps.PROFILES.keys() == ref_apps.PROFILES.keys()
    for name, prof in apps.PROFILES.items():
        assert (dataclasses.astuple(prof)
                == dataclasses.astuple(ref_apps.PROFILES[name])), name
    assert apps.MODEL_FIELDS == ref_apps.MODEL_FIELDS
    for const in ("TOTAL_UNITS_8MB", "TOTAL_BW_GBPS", "MIN_UNITS",
                  "BASELINE_UNITS", "BASELINE_BW_GBPS", "UNIT_KB"):
        assert getattr(apps, const) == getattr(ref_apps, const), const


def test_from_numpy_round_trips_reference_app_arrays():
    ref = ref_apps.stack_mixes(MIXES)
    fields = {f: getattr(ref, f) for f in ref_apps.MODEL_FIELDS}
    fields["names"] = ref.names
    tensors = from_numpy(fields, torch.device("cpu"))
    assert set(tensors) == set(ref_apps.MODEL_FIELDS)
    for f, t in tensors.items():
        assert t.dtype == torch.float64 and t.shape == (SWEEP_MIXES, 16)
        np.testing.assert_array_equal(t.numpy(), getattr(ref, f))
    mine = apps.stack_mixes(MIXES)
    for f in apps.MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    with pytest.raises(KeyError):
        from_numpy({"cpi_base": ref.cpi_base}, torch.device("cpu"))


@pytest.mark.parametrize("total_ms,dynamic", [(100.0, True), (100.0, False),
                                              (37.5, True)])
def test_fig8_schedule_equals_reference(total_ms, dynamic):
    got = types.fig8_schedule(total_ms, types.CBPParams(), dynamic)
    want = ref_coordinator.fig8_schedule(total_ms, ref_types.CBPParams(),
                                         dynamic)
    assert [(s.kind, s.duration_ms) for s in got] == [
        (s.kind, s.duration_ms) for s in want]


def test_cbp_params_guard_matches_reference():
    with pytest.raises(types.ScheduleConfigError):
        types.CBPParams(reconfiguration_interval_ms=0.6)
    with pytest.raises(ref_types.ScheduleConfigError):
        ref_types.CBPParams(reconfiguration_interval_ms=0.6)


def test_stacked_table_aligns_boundaries():
    """The stacked table puts every Lookahead manager's reconfigure on the
    longest table's boundary slots, so one greedy launch serves them."""
    p = types.CBPParams()
    fig8 = segment_table(types.fig8_schedule(100.0, p, True))
    plain = segment_table(types.fig8_schedule(100.0, p, False))
    kinds, acc, reconf = stack_tables([fig8, plain], [None, None])
    assert kinds.shape == (2, len(fig8[0]))
    np.testing.assert_array_equal(reconf[1], reconf[0])
    np.testing.assert_allclose(acc.sum(axis=1), [100.0, 100.0])
