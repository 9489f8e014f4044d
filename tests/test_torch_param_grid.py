"""``run_sweep(param_grid=...)``: the Fig. 12 design space as one sweep.

Against the JAX package (float64, subprocess) on three grids
(``_torch_jax_ref.GRID_CASES``): the reference test's case (two params of
one schedule, one of another; a manager no parameter changes), the decay
constants, and two same-schedule rows that differ in all five per-row
tunables over every manager.  Cache units and prefetch settings exactly;
IPC, bandwidth and geomeans within rtol 1e-9.  Within the port, each
P-slice equals ``run_sweep(params=p)`` bit for bit, on the stacked and
the segment backends.
"""
import numpy as np
import pytest
from _torch_jax_ref import GRID_CASES, jax_reference

from repro_torch.core.types import CBPParams
from repro_torch.sim import CMPConfig, WORKLOADS, run_sweep

BACKENDS = {"stacked": None, "segment": CMPConfig(timeline_backend="segment")}


def case_args(case):
    mixes, names, total_ms, grid = GRID_CASES[case]
    return ([WORKLOADS[w] for w in mixes], names, total_ms,
            [CBPParams(**p) for p in grid])


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_reference("grid", tmp_path_factory)


@pytest.fixture(scope="module")
def grids():
    out = {}
    for backend, cfg in BACKENDS.items():
        for case in GRID_CASES:
            mixes, names, total_ms, grid = case_args(case)
            out[backend, case] = run_sweep(
                mixes, managers=names, total_ms=total_ms, param_grid=grid,
                config=cfg, device="cpu")
    return out


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_param_grid_matches_jax_package(jax_ref, grids, case, backend):
    res = grids[backend, case]
    _mixes, _names, _ms, grid = case_args(case)
    P, M = len(grid), len(res.mixes)
    assert res.param_grid == grid
    np.testing.assert_allclose(res.baseline_ipc,
                               jax_ref[f"{case}|baseline_ipc"], rtol=1e-9)
    for name in res.manager_names:
        key = f"{case}|{name}"
        alloc = res.final_alloc[name]
        assert res.ipc[name].shape == (P, M, 16)
        assert res.weighted_speedup(name).shape == (P, M)
        np.testing.assert_array_equal(alloc.cache_units, jax_ref[f"{key}|units"],
                                      err_msg=name)
        np.testing.assert_array_equal(alloc.prefetch_on, jax_ref[f"{key}|pf"],
                                      err_msg=name)
        np.testing.assert_allclose(res.ipc[name], jax_ref[f"{key}|ipc"],
                                   rtol=1e-9, atol=0, err_msg=name)
        np.testing.assert_allclose(alloc.bandwidth, jax_ref[f"{key}|bw"],
                                   rtol=1e-9, atol=0, err_msg=name)
        np.testing.assert_allclose(res.geomean_speedup(name),
                                   jax_ref[f"{key}|geomean"], rtol=1e-9)
        assert (alloc.cache_units.sum(axis=-1) == 256).all()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_each_slice_equals_its_own_sweep(grids, case, backend):
    res = grids[backend, case]
    mixes, names, total_ms, grid = case_args(case)
    for pi, p in enumerate(grid):
        one = run_sweep(mixes, managers=names, total_ms=total_ms, params=p,
                        config=BACKENDS[backend], device="cpu")
        for name in res.manager_names:
            np.testing.assert_array_equal(res.ipc[name][pi], one.ipc[name],
                                          err_msg=name)
            for f in ("cache_units", "bandwidth", "prefetch_on"):
                np.testing.assert_array_equal(
                    getattr(res.final_alloc[name], f)[pi],
                    getattr(one.final_alloc[name], f), err_msg=f"{name} {f}")


def test_summary_and_geomeans_broadcast_over_p(grids):
    res = grids["stacked", "fig12"]
    summary = res.summary()
    assert len(summary["CBP"]) == 3
    g = res.geomean_speedup("CBP")
    assert g.shape == (3,)
    # equal on is params-static: one value broadcast over P
    assert len(set(summary["equal on"])) == 1
    assert summary["CBP"][0] != summary["CBP"][2]


def test_params_and_param_grid_are_exclusive():
    mixes, _n, _ms, grid = case_args("fig12")
    with pytest.raises(ValueError, match="either params or param_grid"):
        run_sweep(mixes, managers=["CBP"], params=CBPParams(),
                  param_grid=grid, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        run_sweep(mixes, managers=["CBP"], param_grid=[], device="cpu")
