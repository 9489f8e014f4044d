"""The host-coordinated paths on the card: the scalar plant's managers,
the sweep's segment backend, ``param_grid``, the ``CacheController``'s
device backend and the characterization.  Each must launch the Lookahead
greedy kernel where it allocates cache, and agree with the port's CPU run
(discrete outputs exactly, floats within rtol 1e-9).

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_*.py``.  The file imports neither JAX nor the JAX
package.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cache_controller import CacheController
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.core.types import CBPParams
from repro_torch.sim import (
    MANAGER_NAMES,
    CMPConfig,
    WORKLOADS,
    random_mixes,
    run_all_managers,
    run_sweep,
)
from repro_torch.sim import characterization as ch
from repro_torch.sim import timeline

pytestmark = pytest.mark.cuda

FIG1 = ["lbm", "xalancbmk"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Lookahead greedy kernel has "
                    "no CPU interpret mode")


def assert_same(a, b, names, rtol=1e-9):
    for name in names:
        fa, fb = a.final_alloc[name], b.final_alloc[name]
        np.testing.assert_array_equal(fa.cache_units, fb.cache_units,
                                      err_msg=name)
        np.testing.assert_array_equal(fa.prefetch_on, fb.prefetch_on,
                                      err_msg=name)
        np.testing.assert_allclose(a.ipc[name], b.ipc[name], rtol=rtol,
                                   atol=0, err_msg=name)
        np.testing.assert_allclose(fa.bandwidth, fb.bandwidth, rtol=rtol,
                                   atol=0, err_msg=name)


def test_scalar_managers_on_the_card_equal_the_cpu(card):
    names = ["only cache", "CPpf", "CBP", "qos"]
    reset_launch_counts()
    gpu = run_all_managers(FIG1, total_ms=20.0, names=names)
    assert launch_counts()["lookahead_greedy"] == 1 + 2 + 1
    cpu = run_all_managers(FIG1, total_ms=20.0, names=names, device="cpu")
    for name in names:
        np.testing.assert_array_equal(gpu[name].final_alloc.cache_units,
                                      cpu[name].final_alloc.cache_units)
        np.testing.assert_allclose(gpu[name].ipc, cpu[name].ipc, rtol=1e-9)


@pytest.mark.parametrize("backend", ["segment", "stacked"])
def test_sweep_backends_on_the_card_equal_the_cpu(card, backend):
    mixes = random_mixes(3, 16, seed=2)
    cfg = CMPConfig(timeline_backend=backend)
    reset_launch_counts()
    gpu = run_sweep(mixes, total_ms=20.0, config=cfg)
    assert launch_counts()["lookahead_greedy"] > 0
    cpu = run_sweep(mixes, total_ms=20.0, config=cfg, device="cpu")
    assert_same(gpu, cpu, MANAGER_NAMES)


def test_segment_equals_stacked_on_the_card(card):
    mixes = [WORKLOADS["w1"], WORKLOADS["w2"]]
    stacked = run_sweep(mixes, total_ms=20.0)
    seg = run_sweep(mixes, total_ms=20.0,
                    config=CMPConfig(timeline_backend="segment"))
    assert_same(seg, stacked, MANAGER_NAMES)


def test_length_buckets_bit_identical_on_the_card(card, monkeypatch):
    mixes = random_mixes(5, 16, seed=3)
    a = run_sweep(mixes, total_ms=30.0)
    monkeypatch.setattr(timeline, "_length_buckets",
                        lambda lens: [list(range(len(lens)))])
    b = run_sweep(mixes, total_ms=30.0)
    assert_same(a, b, MANAGER_NAMES, rtol=0)


def test_param_grid_on_the_card_equals_the_cpu(card):
    grid = [CBPParams(min_ways=2, atd_decay=0.7, speedup_threshold=1.02),
            CBPParams(min_bandwidth_allocation=2.0, bandwidth_delay_decay=0.8),
            CBPParams(reconfiguration_interval_ms=5.0)]
    mixes = random_mixes(2, 16, seed=5)
    names = ["equal on", "CPpf", "CBP", "auction"]
    gpu = run_sweep(mixes, managers=names, total_ms=20.0, param_grid=grid)
    cpu = run_sweep(mixes, managers=names, total_ms=20.0, param_grid=grid,
                    device="cpu")
    assert_same(gpu, cpu, names)


@pytest.mark.parametrize("masked", [False, True])
def test_cache_controller_device_backend_on_the_card(card, masked):
    rng = np.random.default_rng(9)
    curves = np.cumsum(rng.uniform(0, 2, (2, 5, 16, 257)), axis=-1)
    active = rng.integers(0, 2, (2, 5, 16)).astype(bool)
    mins = rng.integers(1, 6, (2, 5))
    dev = CacheController(256, 4, backend="device")
    host = CacheController(256, 4, backend="numpy")
    t = torch.as_tensor(curves, device="cuda")
    reset_launch_counts()
    if masked:
        got = dev.allocate_masked(t, torch.as_tensor(active, device="cuda"),
                                  min_units=mins)
        want = host.allocate_masked(curves, active, min_units=mins)
    else:
        got = dev.allocate(t, min_units=mins)
        want = host.allocate(curves, min_units=mins)
    assert launch_counts()["lookahead_greedy"] == 1
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_characterization_on_the_card_equals_the_cpu(card):
    gpu, cpu = ch.sensitivity_table(), ch.sensitivity_table(device="cpu")
    for app, row in gpu.items():
        for key, value in row.items():
            np.testing.assert_allclose(value, cpu[app][key], rtol=1e-9,
                                       atol=1e-15, err_msg=(app, key))
    assert ({app: ch.classify(r) for app, r in gpu.items()}
            == {app: ch.classify(r) for app, r in cpu.items()})
