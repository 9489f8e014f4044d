"""Fig. 5's static search of the port on the CPU
(``repro_torch.sim.static_search.search_static(device="cpu")``) against
the reference (``repro.sim.static_search``).

The port must equal the reference's numpy backend index for index, with
no exception, and its weighted speedups (and the Pareto case's
fairness) must be within :data:`RTOL` of it, on the inputs of every case
of ``tests/test_static_search.py`` but the dispatch budgets, the
benchmark entry point and the sharding test, every workload and
parameter kept; the same against the reference's JAX backend run in
float64 in a subprocess (``tests/_torch_jax_ref.py``) on its parity
cases, where the reference holds JAX and numpy to the same indices; and
the same against the committed ``tests/data/static_search_golden.json``
(``tools/static_search_golden.py``), whose cases but the 640-workload
study a test regenerates here so that it cannot go stale.  The host
layer's copies (``random_workloads``, the grids, the registry's static
grids) must equal the reference's.
"""
import dataclasses
import functools
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _static_golden import LONG_CASES, load, port_run
from _torch_jax_ref import STATIC_CASES, jax_reference

from repro.sim import policies as ref_policies
from repro.sim import static_search as R
from repro.sim.workloads import random_workloads as ref_random_workloads
from repro_torch.sim import memsys, policies
from repro_torch.sim import static_search as P
from repro_torch.sim.workloads import random_workloads

ROOT = Path(__file__).resolve().parents[1]

#: Relative limit of the port's weighted speedups, fairness and baseline
#: IPC against the reference (the controllers' float64 tolerance; the
#: port has measured equal bit for bit on these cases).
RTOL = 1e-12

GOLDEN = load()


def _tool():
    """``tools/static_search_golden.py``, which runs the reference's numpy
    search (``reference_run``) and writes the committed file."""
    path = ROOT / "tools" / "static_search_golden.py"
    spec = importlib.util.spec_from_file_location("static_search_golden",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


TOOL = _tool()


def assert_same(got, want, what=""):
    """Indices equal, floats within RTOL, between a port result and a
    reference result (numpy backend)."""
    assert got.family_names == want.family_names, what
    assert got.workloads == want.workloads, what
    assert got.k == want.k and got.multi_objective == want.multi_objective
    np.testing.assert_allclose(got.baseline_ipc, want.baseline_ipc,
                               rtol=RTOL, atol=0, err_msg=what)
    for fam in got.family_names:
        msg = f"{what} {fam}"
        assert got.topk_index[fam].dtype == np.int64, msg
        np.testing.assert_array_equal(got.topk_index[fam],
                                      want.topk_index[fam], err_msg=msg)
        np.testing.assert_allclose(got.topk_ws[fam], want.topk_ws[fam],
                                   rtol=RTOL, atol=0, err_msg=msg)
        if want.multi_objective:
            np.testing.assert_allclose(got.topk_fairness[fam],
                                       want.topk_fairness[fam], rtol=RTOL,
                                       atol=0, err_msg=msg)
        assert np.array_equal(got.grids[fam].valid, want.grids[fam].valid)
    if not want.multi_objective:
        assert got.topk_fairness is None


def both(wls, families=None, **kw):
    """The port on the CPU and the reference's numpy backend."""
    return (P.search_static(wls, families, device="cpu", **kw),
            R.search_static(wls, families and ref_families(families),
                            backend="numpy", **kw))


def ref_families(fams):
    return {name: R.FamilySpec(**dataclasses.asdict(spec))
            for name, spec in fams.items()}


# --------------------------------------------------------------------- #
# the host layer's copies
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n,apps,seed", [(4, 2, 3), (4, 3, 5), (16, 4, 7),
                                         (640, 4, 7), (2, 5, 8)])
def test_random_workloads_equal_the_reference(n, apps, seed):
    assert random_workloads(n, apps, seed=seed) == ref_random_workloads(
        n, apps, seed=seed)


def test_registry_static_grids_equal_the_reference():
    """``PolicyFamily.static_grid`` and ``registry_families`` against the
    reference (``tests/test_static_search.py:416``)."""
    assert policies.manager_names() == ref_policies.manager_names()
    for name in policies.manager_names():
        assert (policies.get_family(name).static_grid
                == ref_policies.get_family(name).static_grid), name
    fams = P.registry_families()
    ref = R.registry_families()
    assert list(fams) == list(ref)
    for name in fams:
        assert dataclasses.asdict(fams[name]) == dataclasses.asdict(
            ref[name]), name
    assert fams["auction"].manage_cache and fams["auction"].manage_bw
    assert fams["qos"].manage_cache and fams["qos"].manage_bw
    assert not fams["bank bw"].manage_cache and fams["bank bw"].manage_bw
    assert fams["bank bw"].bandwidth_banks == 4
    assert list(P.registry_families(["CBP", "bank bw"])) == ["CBP",
                                                             "bank bw"]
    with pytest.raises(policies.UnknownManagerError):
        P.registry_families(["CPB"])


def test_fig5_families_and_options_equal_the_reference():
    assert list(P.FIG5_FAMILIES) == list(R.FIG5_FAMILIES)
    for name, spec in P.FIG5_FAMILIES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            R.FIG5_FAMILIES[name])
    assert P.FIG5_TWO_RESOURCE == R.FIG5_TWO_RESOURCE
    assert dataclasses.asdict(P.StaticOptions()) == dataclasses.asdict(
        R.StaticOptions())
    assert (P.FIG5_ITERS, P.CHUNK_ELEMENTS) == (R.FIG5_ITERS,
                                                R.CHUNK_ELEMENTS)


def _same_grid(got, want):
    for f in ("cache", "bandwidth", "prefetch", "valid"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.total_cache_units, got.total_bandwidth_gbps) == (
        want.total_cache_units, want.total_bandwidth_gbps)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(min_value=1, max_value=3),
       c_lo=st.integers(min_value=4, max_value=16),
       c_hi=st.integers(min_value=17, max_value=48),
       b_hi=st.floats(min_value=2.0, max_value=8.0),
       cache_budget=st.integers(min_value=16, max_value=80),
       bw_budget=st.floats(min_value=2.0, max_value=20.0))
def test_enumerate_grid_equals_the_reference(n, c_lo, c_hi, b_hi,
                                             cache_budget, bw_budget):
    """``tests/test_static_search.py:196``'s examples: the same grid (or
    the same error) and the same padding."""
    args = ([(float(c_lo), float(c_hi))] * n, [(1.0, float(b_hi))] * n,
            [(0.0, 1.0)] * n)
    kw = dict(cache_budget=cache_budget, bw_budget=bw_budget)
    try:
        want = R.enumerate_grid(*args, **kw)
    except R.InfeasibleGridError as exc:
        with pytest.raises(P.InfeasibleGridError) as got:
            P.enumerate_grid(*args, **kw)
        assert str(got.value) == str(exc)
        return
    got = P.enumerate_grid(*args, **kw)
    _same_grid(got, want)
    _same_grid(got.pad_to(7), want.pad_to(7))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_family_grids_equal_the_reference(n):
    """Every Fig. 5 and registry family's grid, and the all-three grid's
    combo count and order (``tests/test_static_search.py:502``)."""
    for spec in [*P.FIG5_FAMILIES.values(),
                 *P.registry_families().values()]:
        _same_grid(P.family_grid(spec, n),
                   R.family_grid(R.FamilySpec(**dataclasses.asdict(spec)),
                                 n))
    if n != 4:
        return
    grid = P.family_grid(P.FamilySpec(True, True, True), n)
    caches = [c for c in itertools.product(*[(8, 16, 32)] * n)
              if sum(c) <= 16 * n]
    bws = [b for b in itertools.product(*[(2.0, 4.0, 6.0)] * n)
           if sum(b) <= 4.0 * n]
    assert grid.n_configs == len(caches) * len(bws) * 2 ** n
    np.testing.assert_array_equal(grid.cache[0], caches[0])
    np.testing.assert_array_equal(grid.cache[-1], caches[-1])


def test_pareto_topk_equals_the_reference():
    """The plain Pareto fold, on candidates with exact duplicates, weak
    dominance and masked entries."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        ws = rng.choice([1.0, 1.1, 1.2, 1.3], 24)
        fair = rng.choice([0.5, 0.6, 0.7], 24)
        fair[rng.random(24) < 0.2] = -np.inf
        ws[np.isinf(fair)] = -np.inf
        idx = rng.permutation(24).astype(np.int64)
        for k in (1, 4, 30):
            for g, w in zip(P._pareto_topk(ws, fair, idx, k),
                            R._pareto_topk(ws, fair, idx, k)):
                assert g.dtype == w.dtype and np.array_equal(g, w)


# --------------------------------------------------------------------- #
# the search against the reference, case by case
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n_apps,seed", [(2, 3), (3, 5)])
def test_matches_numpy_backend(n_apps, seed):
    """``tests/test_static_search.py:55``."""
    assert_same(*both(random_workloads(4, n_apps, seed=seed), k=3))


@pytest.fixture(scope="module")
def jax_static(tmp_path_factory):
    return jax_reference("static_search", tmp_path_factory)


@pytest.mark.parametrize("n_apps,seed", STATIC_CASES)
def test_matches_jax_backend_x64(n_apps, seed, jax_static):
    """The reference's JAX backend in float64 on l.55's cases, where it
    asserts that JAX and numpy agree: the port equals both."""
    got = P.search_static(random_workloads(4, n_apps, seed=seed), k=3,
                          device="cpu")
    key = f"{n_apps}_{seed}"
    np.testing.assert_allclose(got.baseline_ipc,
                               jax_static[f"{key}|baseline_ipc"],
                               rtol=RTOL, atol=0)
    for fam in got.family_names:
        np.testing.assert_array_equal(
            got.topk_index[fam], jax_static[f"{key}|{fam}|topk_index"],
            err_msg=fam)
        np.testing.assert_allclose(
            got.topk_ws[fam], jax_static[f"{key}|{fam}|topk_ws"],
            rtol=RTOL, atol=0, err_msg=fam)


@pytest.mark.parametrize("n_apps,k,seed", [(2, 1, 3), (3, 4, 5)])
def test_stacked_bit_identical_to_per_family(n_apps, k, seed):
    """``tests/test_static_search.py:107``: both forms scan the same
    tables, so they are equal bit for bit, and equal the numpy golden."""
    wls = random_workloads(4, n_apps, seed=seed)
    stacked, ref = both(wls, k=k)
    per = P.search_static(wls, k=k, device="cpu", stack_families=False)
    assert stacked.family_names == per.family_names
    for fam in stacked.family_names:
        np.testing.assert_array_equal(stacked.topk_ws[fam],
                                      per.topk_ws[fam], err_msg=fam)
        np.testing.assert_array_equal(stacked.topk_index[fam],
                                      per.topk_index[fam], err_msg=fam)
    assert_same(stacked, ref)


def test_zero_feasible_configs_raise_the_reference_errors():
    """``tests/test_static_search.py:124``: the same error types and
    messages as the reference."""
    wls = random_workloads(2, 2, seed=0)
    cases = [
        ({"cache_only": P.FamilySpec(manage_cache=True)},
         dict(cache_options=(24.0, 32.0), cache_budget_per_app=16.0)),
        ({"c": P.FamilySpec(manage_cache=True)},
         dict(bw_fixed=40.0, bw_budget_per_app=4.0)),
    ]
    for fams, opts in cases:
        with pytest.raises(R.InfeasibleGridError) as want:
            R.search_static(wls, ref_families(fams),
                            options=R.StaticOptions(**opts),
                            backend="numpy")
        with pytest.raises(P.InfeasibleGridError) as got:
            P.search_static(wls, fams, options=P.StaticOptions(**opts),
                            device="cpu")
        assert str(got.value) == str(want.value)
    assert issubclass(P.InfeasibleGridError, ValueError)


def test_empty_topk_slot_index_refuses_config_lookup():
    """``tests/test_static_search.py:148``."""
    wls = random_workloads(2, 2, seed=1)
    fams = {"equal_on": P.FIG5_FAMILIES["equal_on"]}
    res, ref = both(wls, fams, k=3)
    assert_same(res, ref)
    assert (res.topk_index["equal_on"][:, 1:] == -1).all()
    assert np.isneginf(res.topk_ws["equal_on"][:, 1:]).all()
    with pytest.raises(IndexError, match="top-k slot"):
        res.grids["equal_on"].config(res.topk_index["equal_on"])
    assert res.best_config("equal_on")["cache_units"].shape == (2, 2)


def test_all3_dominates_every_subset_per_workload():
    """``tests/test_static_search.py:162``."""
    res, ref = both(random_workloads(5, 3, seed=11))
    assert_same(res, ref)
    all3 = res.best_ws("cache+bw+pref")
    for fam in res.family_names:
        assert (all3 >= res.best_ws(fam) - 1e-9).all(), fam


def test_validation_matches_the_reference():
    """``tests/test_static_search.py:172`` (the port has no ``backend``)."""
    wls = random_workloads(2, 2, seed=0)
    with pytest.raises(ValueError, match="k must be"):
        P.search_static(wls, k=0, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        P.search_static(wls, families={}, device="cpu")
    with pytest.raises(ValueError):
        P.search_static([["lbm", "gcc"], ["mcf"]], device="cpu")
    with pytest.raises(TypeError):
        P.search_static(wls, backend="numpy", device="cpu")


def test_padding_mask_never_lets_a_masked_config_win():
    """``tests/test_static_search.py:228``: tiny chunks force padding; the
    chunked port equals the unchunked numpy golden."""
    wls = random_workloads(2, 2, seed=0)
    res = P.search_static(wls, k=5, chunk_elements=8, device="cpu")
    ref = R.search_static(wls, k=5, backend="numpy")
    assert_same(res, ref)
    for fam in res.family_names:
        ws, idx = res.topk_ws[fam], res.topk_index[fam]
        finite = np.isfinite(ws)
        assert (idx[finite] >= 0).all()
        assert (idx[finite] < res.grids[fam].n_configs).all()
        assert (idx[~finite] == -1).all()


def test_infeasible_options_never_win():
    """``tests/test_static_search.py:249``."""
    opts = dict(cache_options=(8.0, 64.0), cache_budget_per_app=16.0)
    fam = {"all3": P.FamilySpec(manage_cache=True, manage_bw=True,
                                manage_pf=True)}
    wls = random_workloads(2, 2, seed=6)
    res = P.search_static(wls, fam, options=P.StaticOptions(**opts), k=3,
                          device="cpu")
    ref = R.search_static(wls, ref_families(fam),
                          options=R.StaticOptions(**opts), k=3,
                          backend="numpy")
    assert_same(res, ref)
    assert (res.grids["all3"].cache <= 8.0).all()
    assert (res.best_config("all3")["cache_units"] <= 8.0).all()


@settings(max_examples=6, deadline=None)
@given(k=st.integers(min_value=1, max_value=6),
       seed=st.integers(min_value=0, max_value=5))
def test_topk_sorted_and_deduplicated(k, seed):
    """``tests/test_static_search.py:266``'s examples."""
    wls = random_workloads(2, 2, seed=seed)
    fams = {"bw+pref": P.FIG5_FAMILIES["bw+pref"],
            "cache+bw+pref": P.FIG5_FAMILIES["cache+bw+pref"]}
    res, ref = both(wls, fams, k=k)
    assert_same(res, ref, f"k={k} seed={seed}")
    for fam in res.family_names:
        ws, idx = res.topk_ws[fam], res.topk_index[fam]
        assert ws.shape == idx.shape == (2, k)
        assert (np.diff(ws, axis=-1) <= 1e-12).all(), fam
        for row_ws, row_idx in zip(ws, idx):
            finite = np.isfinite(row_ws)
            assert len(set(row_idx[finite])) == finite.sum(), fam
            assert finite.sum() == min(k, res.grids[fam].n_configs)


def test_arbitrary_napp_workloads_and_custom_grids():
    """``tests/test_static_search.py:284``: 5-app workloads on a finer
    grid."""
    opts = dict(cache_options=(8.0, 16.0, 24.0), bw_options=(2.0, 5.0))
    wls = random_workloads(2, 5, seed=8)
    res = P.search_static(wls, {"all3": P.FamilySpec(True, True, True)},
                          options=P.StaticOptions(**opts), k=2,
                          device="cpu")
    ref = R.search_static(wls, {"all3": R.FamilySpec(True, True, True)},
                          options=R.StaticOptions(**opts), k=2,
                          backend="numpy")
    assert_same(res, ref)
    cfg = res.best_config("all3")
    assert cfg["cache_units"].shape == (2, 5)


def test_pareto_front_case_matches_numpy():
    """``tests/test_static_search.py:342``'s input: the front over the
    whole grid (k = 16, never truncated)."""
    wls = random_workloads(2, 3, seed=6)
    fams = {"cache+bw": P.FIG5_FAMILIES["cache+bw"]}
    res, ref = both(wls, fams, k=16, multi_objective=True)
    assert_same(res, ref)
    for wi in range(2):
        valid = res.topk_index["cache+bw"][wi] >= 0
        assert 2 <= valid.sum() <= 16
        ws_v = res.topk_ws["cache+bw"][wi][valid]
        f_v = res.topk_fairness["cache+bw"][wi][valid]
        assert (np.diff(ws_v) < 0).all() and (np.diff(f_v) > 0).all()
        assert (res.topk_fairness["cache+bw"][wi][~valid] == -np.inf).all()


def test_pareto_case_matches_numpy():
    """``tests/test_static_search.py:373``: indices equal, ws and
    fairness within 1e-12, over several chunks too."""
    wls = random_workloads(3, 2, seed=5)
    fams = {"cache+bw": P.FIG5_FAMILIES["cache+bw"],
            "cache+bw+pref": P.FIG5_FAMILIES["cache+bw+pref"]}
    ref = R.search_static(wls, ref_families(fams), k=6, backend="numpy",
                          multi_objective=True)
    for chunk_elements in (P.CHUNK_ELEMENTS, 60):
        assert_same(P.search_static(wls, fams, k=6, device="cpu",
                                    multi_objective=True,
                                    chunk_elements=chunk_elements), ref,
                    f"chunk_elements={chunk_elements}")


def test_knee_index_picks_balanced_tradeoff():
    """``tests/test_static_search.py:392``."""
    res = P.StaticSearchResult(
        family_names=["f"], workloads=[["a", "b"]], grids={},
        topk_ws={"f": np.array([[3.0, 2.0, 1.0], [5.0, -np.inf, -np.inf]])},
        topk_index={"f": np.array([[5, 7, 9], [2, -1, -1]])},
        baseline_ipc=np.ones((2, 2)), backend="cpu", k=3,
        topk_fairness={"f": np.array([[0.1, 0.9, 1.0],
                                      [0.4, -np.inf, -np.inf]])},
        multi_objective=True)
    np.testing.assert_array_equal(res.knee_index("f"), [7, 2])
    scalar = P.search_static(random_workloads(2, 2, seed=0), k=2,
                             device="cpu")
    with pytest.raises(ValueError, match="multi_objective"):
        scalar.knee_index("cache+bw+pref")


def test_banked_family_matches_numpy():
    """``tests/test_static_search.py:431``: the registry's banked family
    against the numpy golden (where the reference's two backends
    disagree, the numpy one is the golden), and banking moves the
    scores away from the flat model's."""
    wls = random_workloads(2, 2, seed=9)
    res, ref = both(wls, P.registry_families(["bank bw"]), k=2)
    assert_same(res, ref)
    flat, flat_ref = both(wls, {"bank bw": P.FamilySpec(manage_bw=True)},
                          k=2)
    assert_same(flat, flat_ref)
    assert not np.allclose(res.topk_ws["bank bw"], flat.topk_ws["bank bw"])


def test_equal_on_geomean_pinned():
    """``tests/test_static_search.py:474``."""
    res, ref = both(random_workloads(8, 4, seed=7),
                    {"equal_on": P.FIG5_FAMILIES["equal_on"]})
    assert_same(res, ref)
    assert res.geomean("equal_on") == pytest.approx(1.11575462098291,
                                                    abs=1e-6)


def test_stable_selection_of_equal_scores_across_chunks(monkeypatch):
    """All scores equal (the model patched to a constant IPC) over many
    chunks of 5: the top-k is the first k configs in enumeration order,
    and the Pareto front is the first config alone."""
    def constant(params, cache_units, *args, **kw):
        shape = torch.broadcast_shapes(
            torch.as_tensor(cache_units).shape, params["cpi_base"].shape)
        return memsys.SteadyState(*(torch.ones(shape, dtype=torch.float64),)
                                  * 6)

    monkeypatch.setattr(memsys, "evaluate", constant)
    wls = random_workloads(2, 2, seed=0)
    fams = {"cache+bw+pref": P.FIG5_FAMILIES["cache+bw+pref"]}
    res = P.search_static(wls, fams, k=5, chunk_elements=8, device="cpu")
    assert len(res.grids["cache+bw+pref"].valid) > 5 * 5
    np.testing.assert_array_equal(res.topk_index["cache+bw+pref"],
                                  [list(range(5))] * 2)
    np.testing.assert_array_equal(res.topk_ws["cache+bw+pref"], 1.0)
    front = P.search_static(wls, fams, k=3, chunk_elements=8, device="cpu",
                            multi_objective=True)
    np.testing.assert_array_equal(front.topk_index["cache+bw+pref"],
                                  [[0, -1, -1]] * 2)


def test_is_twin_reads_names_and_rows_only():
    """Twins: the same allocation of the same applications under a
    permutation of equal-named positions."""
    grid = P.StaticGrid(
        cache=np.array([[8, 16, 32, 8], [16, 8, 32, 8], [32, 16, 8, 8],
                        [8, 16, 32, 8]], dtype=np.float64),
        bandwidth=np.full((4, 4), 4.0),
        prefetch=np.array([[1, 0, 0, 0], [0, 1, 0, 0], [1, 0, 0, 0],
                           [1, 0, 0, 0]], dtype=np.float64),
        valid=np.ones(4, dtype=bool), total_cache_units=64.0,
        total_bandwidth_gbps=16.0)
    names = ["mcf", "mcf", "lbm", "gcc"]
    assert P.is_twin(grid, names, 0, 1)         # the two mcf swap
    assert P.is_twin(grid, names, 1, 0)
    assert P.is_twin(grid, names, 3, 3)
    assert not P.is_twin(grid, names, 0, 2)     # mcf and lbm swap
    assert not P.is_twin(grid, ["mcf", "gcc", "lbm", "gcc"], 0, 1)
    assert not P.is_twin(grid, names, 0, -1)


@pytest.mark.parametrize("family", ["bank bw", "cache+bw"])
def test_twins_tie_up_to_rounding_in_the_golden_model(family):
    """The twin rule's premise, on the numpy golden model over the smoke
    workloads: twin configs score the same per-application values up to
    rounding, in the banked regime too (each bank-affinity row is a
    rotation of one vector, so an application's position only orders its
    bank sum; there the fixed point amplifies the rounding).  In ``bank bw`` the golden itself ranks workload 15's twins
    39 and 21 (``omnetpp`` at positions 0 and 3 swap 2 and 4 GB/s) by
    2 ulps of weighted speedup."""
    from repro.sim import memsys as golden
    from repro.sim.apps import stack

    aff = golden.bank_affinity(4, 4)
    for row in aff:
        np.testing.assert_allclose(np.sort(row), np.sort(aff[0]), rtol=1e-15)
    spec = {**P.FIG5_FAMILIES, **P.registry_families()}[family]
    # The banked fixed point at saturation amplifies rounding about
    # tenfold every five iterations (ROADMAP caveat R2).
    rtol = 1e-9 if spec.bandwidth_banks > 1 else 1e-13
    grid = P.family_grid(spec, 4)
    wls = random_workloads(16, 4, seed=7)
    base = GOLDEN["smoke"][1]["baseline_ipc"]
    pairs = 0
    for wi, names in enumerate(wls):
        speedup = golden.evaluate(
            stack(names), grid.cache, grid.bandwidth, grid.prefetch,
            total_cache_units=grid.total_cache_units,
            total_bandwidth_gbps=grid.total_bandwidth_gbps,
            bandwidth_banks=spec.bandwidth_banks,
            iters=P.FIG5_ITERS).ipc / base[wi]
        positions = {}
        for a, name in enumerate(names):
            positions.setdefault(name, []).append(a)
        groups = {}       # twins share each name's multiset of rows
        for c in range(grid.n_configs):
            key = tuple(sorted(
                (name, tuple(sorted(zip(grid.cache[c][pos],
                                        grid.bandwidth[c][pos],
                                        grid.prefetch[c][pos]))))
                for name, pos in positions.items()))
            groups.setdefault(key, []).append(c)
        for members in groups.values():
            for c in members[1:]:
                assert P.is_twin(grid, names, members[0], c)
                np.testing.assert_allclose(
                    np.sort(speedup[c]), np.sort(speedup[members[0]]),
                    rtol=rtol)
                pairs += 1
    assert pairs > 0
    if family == "bank bw":
        ws = GOLDEN["smoke_registry"][1]["families"]["bank bw"]
        assert ws["topk_index"][15].tolist()[1:] == [39, 21]
        assert P.is_twin(grid, wls[15], 39, 21)
        w39, w21 = ws["topk_ws"][15][1:]
        assert w39 > w21 and w39 == pytest.approx(w21, rel=1e-15)


# --------------------------------------------------------------------- #
# the committed golden
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", [n for n in TOOL.CASES
                                  if n not in TOOL.LONG_CASES])
def test_committed_golden_is_the_reference_run(name):
    """Every case but the study, regenerated by the tool, equals the
    committed file."""
    committed = json_case(name)
    assert committed == json_roundtrip(
        {"args": TOOL.CASES[name],
         "golden": TOOL.encode(ref_result(name))})


@functools.lru_cache(maxsize=None)
def ref_result(name):
    return TOOL.reference_run(TOOL.CASES[name])


@functools.lru_cache(maxsize=None)
def port_result(name):
    return port_run(GOLDEN[name][0], "cpu")


def json_case(name):
    import json
    return json.loads(TOOL.PATH.read_text())["cases"][name]


def json_roundtrip(obj):
    import json
    return json.loads(TOOL.dumps(obj))


def test_golden_cases_and_arguments_are_the_tools():
    assert list(GOLDEN) == list(TOOL.CASES)
    assert LONG_CASES == TOOL.LONG_CASES
    for name, (args, _) in GOLDEN.items():
        assert args == TOOL.CASES[name]


@pytest.mark.parametrize("name", [n for n in TOOL.CASES
                                  if n not in TOOL.LONG_CASES])
def test_port_equals_committed_golden(name):
    """The smoke configuration (over the Fig. 5 families and over the
    registry's, its banked family among them) and the Pareto case: index
    for index, floats within RTOL."""
    args, want = GOLDEN[name]
    got = port_result(name)
    assert got.workloads == want["workloads"]
    np.testing.assert_allclose(got.baseline_ipc, want["baseline_ipc"],
                               rtol=RTOL, atol=0)
    assert got.family_names == list(want["families"])
    for fam, w in want["families"].items():
        np.testing.assert_array_equal(got.topk_index[fam], w["topk_index"],
                                      err_msg=fam)
        np.testing.assert_allclose(got.topk_ws[fam], w["topk_ws"],
                                   rtol=RTOL, atol=0, err_msg=fam)
        if args["multi_objective"]:
            np.testing.assert_allclose(got.topk_fairness[fam],
                                       w["topk_fairness"], rtol=RTOL,
                                       atol=0, err_msg=fam)
        assert got.geomean(fam) == pytest.approx(want["geomeans"][fam],
                                                 rel=RTOL)


def test_smoke_geo_all3_is_the_record():
    """``results/bench/fig5_smoke.json``'s ``geo_all3``, 1.269."""
    assert round(port_result("smoke").geomean("cache+bw+pref"), 3) == \
        TOOL.RECORD_GEO_ALL3
    assert round(GOLDEN["smoke"][1]["geomeans"]["cache+bw+pref"], 3) == \
        TOOL.RECORD_GEO_ALL3
