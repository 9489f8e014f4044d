"""The scalar plant and its managers against the JAX package's scalar path.

The reference's ``run_all_managers`` runs its numpy golden model with the
numpy allocator; the port's runs its own model on tensors with the
device greedy (its plain version here).  On ``WORKLOADS["w1"]`` and on the
Fig. 1 pair (lbm + xalancbmk, 64 units, 16 GB/s) every manager's cache
units and prefetch settings must be equal, and IPC, bandwidth and
weighted speedup within 1e-9 relative.  ``CBPCoordinator``'s history and
``mean_ipc`` follow the Fig. 8 schedule as in
``tests/test_coordinator_timeline.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import coordinator as ref_coordinator
from repro.sim import managers as ref_managers
from repro.sim import runner as ref_runner
from repro.sim.workloads import WORKLOADS
from repro_torch.core.coordinator import CBPCoordinator
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.core.types import CBPParams, Mode, PrefetchMode, \
    fig8_schedule
from repro_torch.sim import (
    MANAGER_NAMES,
    CMPConfig,
    CMPPlant,
    antt,
    baseline_ipc,
    policies,
    run_all_managers,
    weighted_speedup,
)
from repro_torch.sim.managers import run_manager

FIG1 = ["lbm", "xalancbmk"]
CASES = {"w1": (WORKLOADS["w1"], {}), "fig1": (FIG1, {
    "total_cache_units": 64, "total_bandwidth": 16.0})}
TOTAL_MS = 40.0
PF_MODES = [PrefetchMode.DYNAMIC, PrefetchMode.OFF, PrefetchMode.ON]


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    apps, cfg = CASES[request.param]
    mine = run_all_managers(apps, total_ms=TOTAL_MS, config=CMPConfig(**cfg),
                            device="cpu")
    ref_cfg = ref_runner.CMPConfig(**cfg)
    ref = ref_managers.run_all_managers(apps, total_ms=TOTAL_MS,
                                        config=ref_cfg)
    base = baseline_ipc(apps, CMPConfig(**cfg), device="cpu")
    return mine, ref, base, ref_runner.baseline_ipc(apps, ref_cfg)


@pytest.mark.parametrize("name", MANAGER_NAMES)
def test_run_all_managers_matches_reference_scalar_path(pair, name):
    mine, ref, base, ref_base = pair
    a, b = mine[name].final_alloc, ref[name].final_alloc
    np.testing.assert_array_equal(a.cache_units, b.cache_units)
    np.testing.assert_array_equal(a.prefetch_on, b.prefetch_on)
    np.testing.assert_allclose(mine[name].ipc, ref[name].ipc, rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(a.bandwidth, b.bandwidth, rtol=1e-9, atol=0)
    assert a.cache_mode.value == b.cache_mode.value
    assert a.bandwidth_mode.value == b.bandwidth_mode.value
    np.testing.assert_allclose(
        weighted_speedup(mine[name].ipc, base),
        ref_runner.weighted_speedup(ref[name].ipc, ref_base), rtol=1e-9)
    np.testing.assert_allclose(
        antt(mine[name].ipc, base),
        ref_runner.antt(ref[name].ipc, ref_base), rtol=1e-9)
    assert isinstance(mine[name].ipc, np.ndarray)


def test_baseline_matches_reference(pair):
    _mine, _ref, base, ref_base = pair
    np.testing.assert_allclose(base, ref_base, rtol=1e-12, atol=0)


def test_fig1_cbp_beats_every_pair():
    """Paper Fig. 1, as the reference test states it: CBP beats each pair
    manager; xalancbmk gets most cache, lbm most bandwidth."""
    cfg = CMPConfig(total_cache_units=64, total_bandwidth=16.0)
    base = baseline_ipc(FIG1, cfg, device="cpu")
    res = run_all_managers(FIG1, total_ms=60.0, config=cfg, device="cpu",
                           names=["bw+pref", "bw+cache", "cache+pref",
                                  "CBP"])
    cbp = weighted_speedup(res["CBP"].ipc, base)
    for pair_name in ("bw+pref", "bw+cache", "cache+pref"):
        assert cbp >= weighted_speedup(res[pair_name].ipc, base) - 1e-6
    alloc = res["CBP"].final_alloc
    assert alloc.cache_units[1] > alloc.cache_units[0]
    assert alloc.bandwidth[0] > alloc.bandwidth[1]
    assert bool(alloc.prefetch_on[0]) and not bool(alloc.prefetch_on[1])


def test_registry_binds_every_host_golden():
    plant = CMPPlant(FIG1, CMPConfig(total_cache_units=64,
                                     total_bandwidth=16.0), device="cpu")
    for name, fam in policies.REGISTRY.items():
        assert fam.host_golden is not None, name
    res = policies.get_family("bw+cache").host_golden(plant, 20.0,
                                                      CBPParams())
    np.testing.assert_array_equal(
        res.ipc, run_manager("bw+cache", plant, 20.0).ipc)


def test_unknown_manager_raises():
    plant = CMPPlant(FIG1, device="cpu")
    with pytest.raises(ValueError, match="unknown manager") as ei:
        run_manager("cpb", plant, total_ms=1.0)
    assert "CBP" in str(ei.value)


def test_scalar_path_launches_no_kernel_on_the_cpu():
    reset_launch_counts()
    run_all_managers(FIG1, total_ms=20.0, names=["CBP", "CPpf"],
                     device="cpu")
    assert launch_counts()["lookahead_greedy"] == 0


def test_plant_allocator_backend_resolves():
    assert CMPPlant(FIG1, device="cpu").allocator_backend == "device"
    assert CMPPlant(FIG1, CMPConfig(allocator_backend="numpy"),
                    device="cpu").allocator_backend == "numpy"
    with pytest.raises(ValueError, match="allocator backend"):
        CMPPlant(FIG1, CMPConfig(allocator_backend="jax"), device="cpu")


class PlantWithoutAllocator:
    """A plant that names no allocator backend."""

    def __init__(self, apps):
        plant = CMPPlant(apps, device="cpu")
        self.n_clients = plant.n_clients
        self.total_cache_units = plant.total_cache_units
        self.total_bandwidth = plant.total_bandwidth
        self.device = plant.device
        self.run_interval = plant.run_interval


@pytest.mark.parametrize("manager", ["CBP", "CPpf"])
def test_plant_without_allocator_backend_raises(manager):
    """The coordinator and CPpf read the plant's allocator backend; a
    plant without one is refused rather than run on the host golden."""
    with pytest.raises(AttributeError, match="allocator_backend"):
        run_manager(manager, PlantWithoutAllocator(FIG1), total_ms=10.0)


def test_numpy_allocator_scalar_path_equals_device_path():
    """The host golden and the device greedy take the same decisions."""
    numpy_cfg = CMPConfig(allocator_backend="numpy")
    a = run_all_managers(FIG1, total_ms=20.0, names=["CBP", "CPpf"],
                         config=numpy_cfg, device="cpu")
    b = run_all_managers(FIG1, total_ms=20.0, names=["CBP", "CPpf"],
                         device="cpu")
    for name in ("CBP", "CPpf"):
        np.testing.assert_array_equal(a[name].ipc, b[name].ipc)
        np.testing.assert_array_equal(a[name].final_alloc.cache_units,
                                      b[name].final_alloc.cache_units)


@pytest.mark.parametrize("pf_mode", PF_MODES)
def test_coordinator_history_matches_schedule(pf_mode):
    """CBPCoordinator.run executes exactly the declared timeline."""
    total_ms = 35.0
    coord = CBPCoordinator(CMPPlant(FIG1, device="cpu"), prefetch_mode=pf_mode)
    coord.run(total_ms)
    durations = [rec.duration_ms for rec in coord.history]
    assert all(d > 0.0 for d in durations)
    assert sum(durations) == pytest.approx(total_ms)
    t = 0.0
    for rec in coord.history:
        assert rec.t_ms == pytest.approx(t)
        t += rec.duration_ms
    expected = [s.duration_ms for s in fig8_schedule(
        total_ms, coord.params, pf_mode == PrefetchMode.DYNAMIC)
        if s.duration_ms > 0.0]
    assert durations == pytest.approx(expected)


@pytest.mark.parametrize("pf_mode", PF_MODES)
def test_coordinator_matches_reference_history(pf_mode):
    """Interval by interval, the port's coordinator sees what the
    reference's does: same allocations, IPC within 1e-9; mean_ipc is the
    time-weighted mean over the full run."""
    mine = CBPCoordinator(CMPPlant(FIG1, device="cpu"), prefetch_mode=pf_mode)
    ref = ref_coordinator.CBPCoordinator(ref_runner.CMPPlant(FIG1),
                                         prefetch_mode=ref_prefetch(pf_mode))
    mine.run(30.0)
    ref.run(30.0)
    assert len(mine.history) == len(ref.history)
    for a, b in zip(mine.history, ref.history):
        assert (a.t_ms, a.duration_ms) == (b.t_ms, b.duration_ms)
        np.testing.assert_array_equal(a.alloc.cache_units.numpy(),
                                      b.alloc.cache_units)
        np.testing.assert_array_equal(a.alloc.prefetch_on.numpy(),
                                      b.alloc.prefetch_on)
        np.testing.assert_allclose(a.alloc.bandwidth.numpy(),
                                   b.alloc.bandwidth, rtol=1e-9)
        np.testing.assert_allclose(a.stats.ipc.numpy(), b.stats.ipc,
                                   rtol=1e-9, atol=0)
    manual = sum(rec.stats.ipc * rec.duration_ms for rec in mine.history)
    manual = manual / sum(rec.duration_ms for rec in mine.history)
    np.testing.assert_allclose(mine.mean_ipc(), manual.numpy())
    np.testing.assert_allclose(mine.mean_ipc(), ref.mean_ipc(), rtol=1e-9)


def ref_prefetch(mode: PrefetchMode):
    from repro.core.types import PrefetchMode as RefPrefetchMode
    return RefPrefetchMode(mode.value)


def test_coordinator_keeps_state_on_the_plant_device():
    coord = CBPCoordinator(CMPPlant(FIG1, device="cpu"),
                           cache_mode=Mode.DYNAMIC)
    coord.run(20.0)
    assert isinstance(coord.alloc.cache_units, torch.Tensor)
    assert coord.alloc.cache_units.dtype == torch.int64
    assert int(coord.alloc.cache_units.sum()) == 256
    assert coord.atd.utility_curves().device.type == "cpu"
