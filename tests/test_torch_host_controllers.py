"""The port's stateful controllers against the JAX package's numpy ones,
on seeded inputs: the sampled ATD and the stack-distance monitor
(``core/atd.py``), the host Lookahead golden
(``core/cache_controller_numpy.py``), the ``CacheController`` on both
backends, ``BandwidthController`` and ``PrefetchController``.  Cache
units and prefetch settings exactly; floats within 1e-12."""
import numpy as np
import pytest
import torch
from _torch_jax_ref import greedy_curves

from repro.core import atd as ref_atd
from repro.core import bandwidth_controller as ref_bw
from repro.core import cache_controller as ref_cc
from repro.core import prefetch_controller as ref_pf
from repro_torch.core import atd, cache_controller_numpy
from repro_torch.core.bandwidth_controller import BandwidthController
from repro_torch.core.cache_controller import CacheController
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.core.prefetch_controller import PrefetchController

T = torch.as_tensor
KINDS = ("concave", "nonmonotone", "flat")


def test_sampled_atd_matches_reference():
    rng = np.random.default_rng(1)
    mine, ref = atd.SampledATD(5, 32, device="cpu"), ref_atd.SampledATD(5, 32)
    for step in range(4):
        curves = np.cumsum(rng.uniform(0, 3, (5, 33)), axis=-1)
        mine.record(T(curves))
        ref.record(curves)
        mine.halve(0.5 if step % 2 else 0.7)
        ref.halve(0.5 if step % 2 else 0.7)
        np.testing.assert_array_equal(mine.utility_curves().numpy(),
                                      ref.utility_curves())
    # utility_curves hands out a copy
    mine.utility_curves().zero_()
    np.testing.assert_array_equal(mine.utility_curves().numpy(),
                                  ref.utility_curves())
    with pytest.raises(ValueError, match="expected"):
        mine.record(torch.zeros(5, 32, dtype=torch.float64))
    mine.reset()
    assert not mine.utility_curves().any()


def test_stack_distance_monitor_matches_reference():
    rng = np.random.default_rng(2)
    mine, ref = atd.StackDistanceMonitor(8), ref_atd.StackDistanceMonitor(8)
    for key in rng.integers(0, 12, 300):
        assert mine.access(int(key)) == ref.access(int(key))
    mine.halve()
    ref.halve()
    np.testing.assert_array_equal(mine.utility_curve(), ref.utility_curve())
    assert mine.accesses == ref.accesses


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("masked", [False, True])
def test_numpy_golden_matches_reference(kind, masked):
    rng = np.random.default_rng(3)
    curves = greedy_curves(rng, 6, 8, 64, kind)
    for b in range(6):
        mins = int(rng.integers(0, 5))
        if masked:
            active = rng.integers(0, 2, 8).astype(bool)
            got = cache_controller_numpy.cppf_allocate(curves[b], 64, mins,
                                                       active)
            want = ref_cc.cppf_allocate(curves[b], 64, mins, active)
        else:
            got = cache_controller_numpy.lookahead_allocate(curves[b], 64,
                                                            mins)
            want = ref_cc.lookahead_allocate(curves[b], 64, mins)
        np.testing.assert_array_equal(got, want)


def test_numpy_golden_counts_calls_and_checks_inputs():
    cache_controller_numpy.reset_allocator_calls()
    cache_controller_numpy.lookahead_allocate(np.zeros((4, 33)), 32, 2)
    cache_controller_numpy.cppf_allocate(np.zeros((4, 33)), 32, 2,
                                         np.array([1, 0, 1, 0], bool))
    assert cache_controller_numpy.allocator_calls() == 2
    with pytest.raises(ValueError, match="points"):
        cache_controller_numpy.lookahead_allocate(np.zeros((4, 30)), 32)
    with pytest.raises(ValueError, match="capacity"):
        cache_controller_numpy.lookahead_allocate(np.zeros((4, 33)), 32, 9)


@pytest.mark.parametrize("backend", ["numpy", "device", "jax", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_cache_controller_matches_reference(backend, masked):
    """Both backends equal the reference's numpy controller on a batch
    with per-row floors; the reference's "jax"/"pallas" names mean the
    device greedy."""
    rng = np.random.default_rng(4)
    curves = np.concatenate([greedy_curves(rng, 3, 8, 64, k) for k in KINDS])
    curves = curves.reshape(3, 3, 8, 65)
    mins = rng.integers(0, 5, (3, 3))
    active = rng.integers(0, 2, (3, 3, 8)).astype(bool)
    ref = ref_cc.CacheController(64, 4, backend="numpy")
    mine = CacheController(64, 4, backend=backend)
    assert mine.backend == ("numpy" if backend == "numpy" else "device")
    cache_controller_numpy.reset_allocator_calls()
    reset_launch_counts()
    if masked:
        got = mine.allocate_masked(T(curves), T(active), min_units=mins)
        want = ref.allocate_masked(curves, active, min_units=mins)
    else:
        got = mine.allocate(T(curves), min_units=mins)
        want = ref.allocate(curves, min_units=mins)
    assert got.dtype == torch.int64 and got.shape == (3, 3, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the numpy backend loops the host golden per row; the device backend
    # makes no host call and, on the CPU, launches no kernel
    if backend == "numpy":
        assert cache_controller_numpy.allocator_calls() >= 1
    else:
        assert cache_controller_numpy.allocator_calls() == 0
    assert launch_counts()["lookahead_greedy"] == 0


def test_cache_controller_scalar_floor_and_2d_curves():
    rng = np.random.default_rng(5)
    curves = greedy_curves(rng, 1, 16, 256, "concave")[0]
    want = ref_cc.CacheController(256, 4).allocate(curves)
    for backend in ("numpy", "device"):
        got = CacheController(256, 4, backend=backend).allocate(T(curves))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="unknown backend"):
        CacheController(256, 4, backend="tpu")
    with pytest.raises(ValueError, match="capacity"):
        CacheController(256, 17).allocate(T(curves))


@pytest.mark.parametrize("rows", [False, True])
def test_bandwidth_controller_matches_reference(rows):
    rng = np.random.default_rng(6)
    shape = (4, 16) if rows else (16,)
    floor = rng.uniform(0.5, 2.0, (4, 1)) if rows else 1.0
    decay = rng.uniform(0.2, 0.9, (4, 1)) if rows else 0.5
    mine = BandwidthController(64.0, floor, decay=decay)
    ref = ref_bw.BandwidthController(64.0, floor, decay=decay)
    with pytest.raises(RuntimeError, match="no delays"):
        mine.allocate()
    for _ in range(3):
        delay = rng.uniform(0.0, 40.0, shape)
        mine.observe(T(delay))
        ref.observe(delay)
        np.testing.assert_allclose(mine.allocate().numpy(), ref.allocate(),
                                   rtol=1e-12, atol=1e-12)
    floor_too_high = BandwidthController(64.0, 5.0)
    floor_too_high.observe(T(np.ones(16)))
    with pytest.raises(ValueError, match="exceeds"):
        floor_too_high.allocate()


def test_prefetch_controller_matches_reference():
    rng = np.random.default_rng(7)
    mine = PrefetchController(16, 1.05, device="cpu")
    ref = ref_pf.PrefetchController(16, 1.05)
    assert not mine.enabled.any() and bool((mine.last_speedup == 1).all())
    for _ in range(3):
        w, wo = rng.uniform(0.1, 2.0, (2, 16))
        wo[:3] = 0.0
        np.testing.assert_array_equal(mine.update(T(w), T(wo)).numpy(),
                                      ref.update(w, wo))
        np.testing.assert_array_equal(mine.last_speedup.numpy(),
                                      ref.last_speedup)
