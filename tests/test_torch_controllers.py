"""The port's controllers against the JAX package (float64, subprocess)
and the numpy goldens: Algorithm-1 bandwidth and Algorithm-2 throttling
within 1e-12, the auction and QoS boundary branches with exact cache
units and bandwidth within 1e-12."""
import numpy as np
import pytest
import torch
from _torch_jax_ref import jax_reference

from repro.core.bandwidth_controller import allocate_bandwidth as bw_golden
from repro.core.prefetch_controller import throttle_decision as thr_golden
from repro.sim import policies as pol_golden
from repro_torch.core.bandwidth_controller import (
    allocate_bandwidth,
    check_bandwidth_floor,
)
from repro_torch.core.prefetch_controller import throttle_decision
from repro_torch.sim import policies

T = torch.as_tensor


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("controllers", tmp_path_factory)


@pytest.mark.parametrize("floor", ["scalar", "rows"])
def test_bandwidth_matches_jax_and_numpy(ref, floor):
    min_alloc = 1.0 if floor == "scalar" else ref["min_alloc"]
    got = allocate_bandwidth(T(ref["delay"]), 64.0, T(min_alloc)).numpy()
    np.testing.assert_allclose(got, ref[f"bw_{floor}"], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got, bw_golden(ref["delay"], 64.0,
                                              min_alloc),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.sum(-1), 64.0, rtol=1e-12)
    # The nobody-queued row splits the remainder evenly.
    np.testing.assert_allclose(got[0], got[0, 0], rtol=0)


def test_bandwidth_floor_check_raises():
    with pytest.raises(ValueError):
        check_bandwidth_floor(5.0, 16, 64.0)
    check_bandwidth_floor(4.0, 16, 64.0)


@pytest.mark.parametrize("threshold", ["scalar", "rows"])
def test_throttle_matches_jax_and_numpy(ref, threshold):
    thr = 1.05 if threshold == "scalar" else ref["thr"]
    got = throttle_decision(T(ref["perf_with"]), T(ref["perf_without"]),
                            T(thr)).numpy()
    np.testing.assert_array_equal(got, ref[f"thr_{threshold}"])
    np.testing.assert_array_equal(
        got, thr_golden(ref["perf_with"], ref["perf_without"], thr))


def test_auction_matches_jax_and_numpy(ref):
    U = int(ref["U"])
    units, bw = policies.auction_allocate(
        T(ref["curves"]), T(ref["delay"]), min_ways=T(ref["min_ways"]),
        total_units=U, min_bandwidth=T(ref["min_alloc"]),
        total_bandwidth=64.0)
    np.testing.assert_array_equal(units.numpy(), ref["auction_units"])
    np.testing.assert_allclose(bw.numpy(), ref["auction_bw"], rtol=1e-12,
                               atol=1e-12)
    g_units, g_bw = pol_golden.auction_allocate(
        ref["curves"], ref["delay"], min_ways=ref["min_ways"],
        total_units=U, min_bandwidth=ref["min_alloc"], total_bandwidth=64.0)
    np.testing.assert_array_equal(units.numpy(), g_units)
    np.testing.assert_allclose(bw.numpy(), g_bw, rtol=1e-12, atol=1e-12)
    assert (units.numpy().sum(-1) == U).all()


def test_qos_matches_jax_and_numpy(ref):
    U = int(ref["U"])
    units, bw = policies.qos_allocate(
        T(ref["curves"]), T(ref["delay"]), T(ref["slowdown"]),
        min_ways=T(ref["min_ways"]), total_units=U,
        min_bandwidth=T(ref["min_alloc"]), total_bandwidth=64.0,
        bound=T(ref["bound"]), gain=T(ref["gain"]))
    np.testing.assert_array_equal(units.numpy(), ref["qos_units"])
    np.testing.assert_allclose(bw.numpy(), ref["qos_bw"], rtol=1e-12,
                               atol=1e-12)
    g_units, g_bw = pol_golden.qos_allocate(
        ref["curves"], ref["delay"], ref["slowdown"],
        min_ways=ref["min_ways"], total_units=U,
        min_bandwidth=ref["min_alloc"], total_bandwidth=64.0)
    np.testing.assert_array_equal(units.numpy(), g_units)
    np.testing.assert_allclose(bw.numpy(), g_bw, rtol=1e-12, atol=1e-12)


def test_largest_remainder_round_matches_jax(ref):
    got = policies.largest_remainder_round(T(ref["lrr_target"]),
                                           int(ref["U"]))
    np.testing.assert_array_equal(got.numpy(), ref["lrr"])
    assert (got.numpy().sum(-1) == int(ref["U"])).all()


def _family_values(family):
    """A family's registry entry with its enums as plain values (the port's
    Mode enums are its own copies)."""
    modes = None if family.modes is None else [m.value for m in family.modes]
    return (modes, family.variant, family.cache_policy, family.bw_policy,
            family.bandwidth_banks)


def test_registry_copy_equals_reference_registry():
    assert policies.manager_names() == pol_golden.manager_names()
    for name in policies.manager_names():
        assert _family_values(policies.get_family(name)) == _family_values(
            pol_golden.get_family(name)), name
    with pytest.raises(policies.UnknownManagerError):
        policies.get_family("no such manager")
