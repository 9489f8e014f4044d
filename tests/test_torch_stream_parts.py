"""The streaming sweep's parts in the port against the reference, in
process: the stream half of ``sim/workloads.py`` array for array, the
online aggregates on the reference tests' hand-computed chunks, the fault
plans and ``poison_tree``, the watchdog and elastic mesh, the ``extra=``
validator, and the checkpoints: the reference tests' crash windows on the
port's ``ckpt`` module, checkpoints read across the two packages both
ways, and the port's msgpack codec byte for byte against ``msgpack``.

The reference's ``checkpoint``, ``runtime`` and ``stream_sweep`` modules
import JAX (and ``msgpack`` / ``ml_dtypes``), which an installation for
the card may lack, so tests that need them take them with
``pytest.importorskip`` inside the test.
"""
import numpy as np
import pytest
import torch

from repro.sim import apps as ref_apps
from repro.sim import policies as ref_policies
from repro.sim import workloads as ref_workloads
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.runtime.fault import (
    ElasticMesh,
    StragglerWatchdog,
    factorize_mesh,
)
from repro_torch.runtime.faultinject import (
    FAULT_KINDS,
    FaultPlan,
    FaultSpec,
    InjectedDispatchError,
    InjectedFault,
    InjectedProcessKill,
    poison_tree,
)
from repro_torch.sim import policies, workloads
from repro_torch.sim.stream_sweep import StreamAggregates
from repro_torch.sim.workloads import (
    StreamScenario,
    iter_mix_index_chunks,
    mix_index_chunk,
    names_from_indices,
    params_from_indices,
    scenario_chunk,
)

#: Scenarios the chunks are compared under: uniform, zipf, diurnal, phase
#: drift, all at once, and unbalanced uniform.
SCENARIOS = {
    "uniform": {},
    "zipf": {"popularity": "zipf", "zipf_exponent": 1.5,
             "catalog_size": 64},
    "diurnal": {"diurnal_period_chunks": 4, "diurnal_amplitude": 0.8},
    "phase": {"phase_app_fraction": 0.25, "phase_amplitude": 0.4,
              "phase_period_chunks": 3},
    "all": {"popularity": "zipf", "diurnal_period_chunks": 24,
            "phase_app_fraction": 0.25},
    "unbalanced": {"balanced": False, "apps_per_mix": 4},
}
#: (seed, chunk index, chunk size) pairs.
CHUNKS = ((0, 0, 4), (11, 3, 16), (7, 23, 64), (3, 1, 1))


def _arrays_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ------------------------- the stream's mixes ------------------------ #


def test_mix_index_chunk_golden():
    """The reference test's pinned rows (l.67-80) from the port."""
    idx = mix_index_chunk(0, 0, 4)
    assert idx.shape == (4, 16) and idx.dtype == np.int32
    assert idx[0].tolist() == [11, 24, 24, 24, 15, 21, 25, 5, 5, 16, 8,
                               21, 0, 26, 2, 22]
    assert idx[3].tolist() == [6, 22, 11, 26, 11, 19, 23, 28, 25, 27, 19,
                               1, 20, 24, 19, 18]
    assert mix_index_chunk(0, 1, 4)[0].tolist() == [
        22, 19, 27, 1, 3, 27, 20, 0, 16, 3, 2, 8, 13, 3, 6, 23]
    np.testing.assert_array_equal(idx, mix_index_chunk(0, 0, 4))


@pytest.mark.parametrize("seed,chunk,size", CHUNKS)
@pytest.mark.parametrize("apps,balanced", [(16, True), (6, True),
                                           (4, False)])
def test_mix_index_chunk_equals_reference(seed, chunk, size, apps,
                                          balanced):
    got = mix_index_chunk(seed, chunk, size, apps, balanced)
    want = ref_workloads.mix_index_chunk(seed, chunk, size, apps, balanced)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_iter_mix_index_chunks_equals_reference():
    got = list(iter_mix_index_chunks(10, 4, seed=3))
    want = list(ref_workloads.iter_mix_index_chunks(10, 4, seed=3))
    assert [c.shape[0] for c in got] == [4, 4, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], mix_index_chunk(3, 1, 4))
    np.testing.assert_array_equal(got[2], mix_index_chunk(3, 2, 4)[:2])
    with pytest.raises(ValueError):
        next(iter_mix_index_chunks(10, 0))


def test_tables_equal_reference():
    np.testing.assert_array_equal(workloads._PARAM_MATRIX,
                                  ref_workloads._PARAM_MATRIX)
    for g, w in zip(workloads._BUCKET_INDICES,
                    ref_workloads._BUCKET_INDICES):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for name in ("_CACHE_SENSITIVE", "_BW_SENSITIVE"):
        np.testing.assert_array_equal(getattr(workloads, name),
                                      getattr(ref_workloads, name))


def test_params_and_names_from_indices_equal_reference():
    idx = mix_index_chunk(5, 0, 3)
    _arrays_equal(params_from_indices(idx),
                  ref_workloads.params_from_indices(idx))
    names = names_from_indices(idx)
    assert names == ref_workloads.names_from_indices(idx)
    params = params_from_indices(idx)
    assert params["mpki_min_alloc"].shape == (3, 16)
    for m in range(3):
        for a in range(16):
            assert (params["cpi_base"][m, a]
                    == ref_apps.PROFILES[names[m][a]].cpi_base)
    with pytest.raises(ValueError):
        params_from_indices(idx[0])


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("seed,chunk,size", CHUNKS)
def test_scenario_chunk_equals_reference(scenario, seed, chunk, size):
    kw = SCENARIOS[scenario]
    got = scenario_chunk(StreamScenario(**kw), seed, chunk, size)
    want = ref_workloads.scenario_chunk(
        ref_workloads.StreamScenario(**kw), seed, chunk, size)
    _arrays_equal(got, want)


#: ``default_rng([11, 0, 0x21BF]).zipf(1.2, 16)`` as numpy 2.0.2 draws it
#: (the ranks of the bench smoke's chunk 0; numpy 2.3.5 draws others).
ZIPF_RANKS = [65, 683, 9, 79, 555, 4, 2, 8, 2, 163206361, 1, 7, 1, 1227615,
              22, 13]


def test_zipf_is_numpy_2_0s():
    got = workloads._zipf(workloads._chunk_rng(11, 0, salt=0x21BF), 1.2, 16)
    assert got.dtype == np.int64 and got.tolist() == ZIPF_RANKS


@pytest.mark.parametrize("a", [1.2, 1.5, 2.0, 3.7])
def test_zipf_equals_installed_numpys(a):
    """Where numpy still draws zipf ranks by its 2.0 algorithm (numpy
    2.0.2 wrote the reference's goldens), the port's sampler equals
    ``Generator.zipf`` over many seeds."""
    probe = workloads._chunk_rng(11, 0, salt=0x21BF).zipf(1.2, size=16)
    if probe.tolist() != ZIPF_RANKS:
        pytest.skip(f"numpy {np.__version__} draws zipf ranks by a newer "
                    f"algorithm than the reference's goldens")
    for seed in range(40):
        want = np.random.default_rng([seed, 5, 0x21BF]).zipf(a, size=300)
        got = workloads._zipf(np.random.default_rng([seed, 5, 0x21BF]), a,
                              300)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [0, 1, 6, 12, 18, 23])
def test_diurnal_fill_p_equals_reference(chunk):
    kw = SCENARIOS["all"]
    got = workloads._diurnal_fill_p(StreamScenario(**kw), chunk)
    want = ref_workloads._diurnal_fill_p(
        ref_workloads.StreamScenario(**kw), chunk)
    np.testing.assert_array_equal(got, want)
    assert workloads._diurnal_fill_p(StreamScenario(), chunk) is None


def test_scenario_validation_equals_reference():
    for bad in ({"popularity": "pareto"}, {"phase_app_fraction": 1.5},
                {"diurnal_amplitude": -0.1},
                {"popularity": "zipf", "zipf_exponent": 1.0}):
        with pytest.raises(ValueError) as mine:
            StreamScenario(**bad)
        with pytest.raises(ValueError) as theirs:
            ref_workloads.StreamScenario(**bad)
        assert str(mine.value) == str(theirs.value)
    assert (StreamScenario().__dict__
            == ref_workloads.StreamScenario().__dict__)


def test_scenario_chunk_deterministic_and_shaped():
    sc = StreamScenario(apps_per_mix=6, popularity="zipf",
                        diurnal_period_chunks=4, phase_app_fraction=0.5)
    a = scenario_chunk(sc, 11, 3, 8)
    b = scenario_chunk(sc, 11, 3, 8)
    _arrays_equal(a, b)
    assert a["mpki_min_alloc"].shape == (8, 6)
    c = scenario_chunk(sc, 11, 5, 8)
    assert not np.array_equal(a["mpki_min_alloc"], c["mpki_min_alloc"])


def test_zipf_popularity_concentrates_catalog():
    sc = StreamScenario(apps_per_mix=6, popularity="zipf",
                        zipf_exponent=1.5, catalog_size=64)
    rows = [scenario_chunk(sc, 0, c, 32)["mpki_min_alloc"] for c in range(4)]
    flat = np.concatenate([r.ravel() for r in rows])
    _, counts = np.unique(flat, return_counts=True)
    assert counts.max() > 4 * np.median(counts)


# ---------------------- aggregate fold closed-form ------------------ #


def test_aggregates_fold_hand_computed_chunk():
    """l.130-173: K = 2 managers, M = 2 mixes, n = 3 apps; bin width 1.0
    and bin 4 the overflow bucket."""
    agg = StreamAggregates(n_managers=2, hist_bins=5, hist_max_slowdown=4.0)
    assert agg.bin_width == 1.0
    ws = np.array([[1.2, 1.5], [1.0, 2.0]])
    slowdown = np.array([
        [[0.5, 1.5, 2.5], [3.5, 10.0, 0.2]],   # bins 0,1,2 | 3, OVF, 0
        [[1.0, 1.0, 1.0], [1.0, 1.0, 9.0]],    # bins 1,1,1 | 1, 1, OVF
    ])
    fairness = np.array([[0.8, 0.6], [0.9, 0.7]])
    agg.fold(ws, slowdown, fairness)

    np.testing.assert_array_equal(agg.slowdown_hist,
                                  [[2, 1, 1, 1, 1], [0, 5, 0, 0, 1]])
    np.testing.assert_array_equal(agg.mix_count, [2, 2])
    np.testing.assert_array_equal(agg.max_slowdown, [10.0, 9.0])
    np.testing.assert_array_equal(agg.min_fairness, [0.6, 0.7])
    np.testing.assert_allclose(
        agg.geomean_ws(), [np.sqrt(1.2 * 1.5), np.sqrt(2.0)], rtol=1e-15)
    np.testing.assert_allclose(agg.slowdown_percentile(0.5), [2.0, 1.6])
    np.testing.assert_allclose(agg.slowdown_percentile(0.9), [4.4, 4.4])
    np.testing.assert_allclose(agg.slowdown_percentile(0.99), [4.94, 4.94])


def test_aggregates_fold_accumulates_across_chunks():
    """l.176-198: histograms add, min-fairness and max-slowdown run."""
    agg = StreamAggregates(n_managers=2, hist_bins=5, hist_max_slowdown=4.0)
    agg.fold(np.array([[1.2, 1.5], [1.0, 2.0]]),
             np.array([[[0.5, 1.5, 2.5], [3.5, 10.0, 0.2]],
                       [[1.0, 1.0, 1.0], [1.0, 1.0, 9.0]]]),
             np.array([[0.8, 0.6], [0.9, 0.7]]))
    agg.fold(np.ones((2, 2)),
             np.full((2, 2, 3), 0.1),                # all bin 0
             np.array([[0.9, 0.95], [0.5, 0.8]]))

    np.testing.assert_array_equal(agg.slowdown_hist,
                                  [[8, 1, 1, 1, 1], [6, 5, 0, 0, 1]])
    np.testing.assert_array_equal(agg.mix_count, [4, 4])
    np.testing.assert_array_equal(agg.min_fairness, [0.6, 0.5])
    np.testing.assert_array_equal(agg.max_slowdown, [10.0, 9.0])
    np.testing.assert_allclose(agg.geomean_ws(),
                               [1.8 ** 0.25, 2.0 ** 0.25], rtol=1e-15)
    np.testing.assert_allclose(agg.slowdown_percentile(0.5), [0.75, 1.0])


def test_aggregates_empty_percentile_is_nan():
    agg = StreamAggregates(n_managers=1, hist_bins=4, hist_max_slowdown=2.0)
    assert np.isnan(agg.slowdown_percentile(0.5)).all()


def test_aggregates_equal_reference_bit_for_bit():
    """Random chunks folded by both packages give the same trees and
    queries, bit for bit; ``load_tree`` round-trips."""
    ref = pytest.importorskip("repro.sim.stream_sweep")
    rng = np.random.default_rng(4)
    mine = StreamAggregates(3, 64, 8.0)
    theirs = ref.StreamAggregates(3, 64, 8.0)
    for _ in range(5):
        ws = rng.uniform(0.5, 2.0, (3, 7))
        slowdown = rng.uniform(0.0, 12.0, (3, 7, 5))
        fairness = rng.uniform(0.1, 1.0, (3, 7))
        mine.fold(ws, slowdown, fairness)
        theirs.fold(ws, slowdown, fairness)
    for key, a in mine.to_tree().items():
        b = theirs.to_tree()[key]
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    for q in (0.5, 0.9, 0.99):
        np.testing.assert_array_equal(mine.slowdown_percentile(q),
                                      theirs.slowdown_percentile(q))
    np.testing.assert_array_equal(mine.geomean_ws(), theirs.geomean_ws())
    back = StreamAggregates(3, 64, 8.0)
    back.load_tree(theirs.to_tree())
    for key, a in back.to_tree().items():
        np.testing.assert_array_equal(a, mine.to_tree()[key])


# -------------------------- fault plans ----------------------------- #


def test_fault_plan_hooks_and_helpers():
    plan = FaultPlan((FaultSpec("dispatch_error", 1, count=2),
                      FaultSpec("nan_poison", 2),
                      FaultSpec("kill", 3),
                      FaultSpec("straggle", 0, seconds=2.5)))
    plan.on_chunk_start(0)
    with pytest.raises(InjectedProcessKill):
        plan.on_chunk_start(3)
    with pytest.raises(InjectedDispatchError):
        plan.on_dispatch(1, 0)
    with pytest.raises(InjectedDispatchError):
        plan.on_dispatch(1, 1)
    plan.on_dispatch(1, 2)  # third attempt succeeds
    assert plan.poisons(2) and not plan.poisons(1)
    assert plan.straggle_seconds(0) == 2.5
    assert plan.kill_chunks() == [3]
    assert plan.without_kills().kill_chunks() == []
    assert FaultPlan.from_dicts(plan.to_dicts()).to_dicts() == plan.to_dicts()
    with pytest.raises(ValueError):
        FaultPlan((FaultSpec("nan_poison", 2), FaultSpec("nan_poison", 2)))
    with pytest.raises(ValueError):
        FaultSpec("frobnicate", 0)
    # a kill tears through ``except Exception`` recovery paths
    assert not issubclass(InjectedProcessKill, Exception)
    assert issubclass(InjectedDispatchError, InjectedFault)
    assert FAULT_KINDS == ("dispatch_error", "nan_poison", "kill",
                           "straggle")


def test_fault_plan_seeded_deterministic():
    mk = lambda: FaultPlan.seeded(9, 50, p_dispatch_error=0.2,  # noqa: E731
                                  p_nan_poison=0.1, p_straggle=0.1)
    assert mk().to_dicts() == mk().to_dicts()
    assert mk().kill_chunks() == []  # kills are never drawn randomly


def test_fault_plan_seeded_equals_reference():
    ref = pytest.importorskip("repro.runtime.faultinject")
    kw = dict(p_dispatch_error=0.2, p_nan_poison=0.1, p_straggle=0.1,
              straggle_seconds=3.0, max_dispatch_failures=4)
    assert (FaultPlan.seeded(9, 50, **kw).to_dicts()
            == ref.FaultPlan.seeded(9, 50, **kw).to_dicts())


def test_poison_tree_on_tensors_and_arrays():
    tree = {"ipc": torch.ones(2, 3, dtype=torch.float64),
            "pair": (np.arange(4.0), [torch.zeros(2, dtype=torch.float32)]),
            "none": None}
    out = poison_tree(tree)
    assert isinstance(out["ipc"], torch.Tensor)
    assert out["ipc"].dtype == torch.float64 and out["ipc"].shape == (2, 3)
    assert out["ipc"].device == tree["ipc"].device
    assert torch.isnan(out["ipc"]).all()
    arr, (t,) = out["pair"][0], out["pair"][1]
    assert isinstance(out["pair"], tuple) and isinstance(out["pair"][1], list)
    assert isinstance(arr, np.ndarray) and np.isnan(arr).all()
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    assert torch.isnan(t).all()
    assert out["none"] is None
    assert (poison_tree(np.zeros(3), 7.0) == 7.0).all()
    # the input is left as it was
    assert (tree["ipc"] == 1.0).all()


# ---------------------- watchdog and elastic mesh -------------------- #


def test_watchdog_median_warmup_survives_compile_spike():
    """l.232-247: a slow first step must not seed the baseline."""
    slow_first = [50.0, 1.0, 1.1] + [1.0] * 5 + [4.0, 4.0, 4.0]
    wd = StragglerWatchdog(threshold=2.0, quarantine_after=3, warmup=3)
    trig = [wd.observe(i, t) for i, t in enumerate(slow_first)]
    assert len(wd.events) == 3 and wd.mitigations == 1 and trig[-1]
    wd_old = StragglerWatchdog(threshold=2.0, quarantine_after=3, warmup=1)
    for i, t in enumerate(slow_first):
        assert not wd_old.observe(i, t)
    assert wd_old.events == []
    with pytest.raises(ValueError):
        StragglerWatchdog(warmup=0)


def test_elastic_mesh():
    assert factorize_mesh(8, model_divisors=(1, 2, 4, 8),
                          prefer_model=4) == (2, 4)
    assert factorize_mesh(6, model_divisors=(4,), prefer_model=4) is None
    mesh = ElasticMesh(model_divisors=(1, 2, 4), prefer_model=4)
    assert mesh.remesh(12) == (3, 4)
    assert mesh.remesh(6) == (3, 2)
    assert mesh.history == [(12, (3, 4)), (6, (3, 2))]
    with pytest.raises(ValueError):
        ElasticMesh(model_divisors=(4,)).remesh(3)


# -------------------------- the validator ---------------------------- #


def test_validator_extra_equals_reference():
    policies.validate_manager_names(["CBP", "oracle"], extra=("oracle",))
    ref_policies.validate_manager_names(["CBP", "oracle"],
                                        extra=("oracle",))
    for names, extra in ((["CBP", "nonsense"], ()),
                         (["nonsense"], ("oracle",))):
        with pytest.raises(policies.UnknownManagerError) as mine:
            policies.validate_manager_names(names, extra=extra)
        with pytest.raises(ref_policies.UnknownManagerError) as theirs:
            ref_policies.validate_manager_names(names, extra=extra)
        assert str(mine.value) == str(theirs.value)
        assert mine.value.name == theirs.value.name == "nonsense"
        assert mine.value.valid == theirs.value.valid
        assert isinstance(mine.value, ValueError)
    assert policies.UnknownManagerError("x").valid == policies.manager_names()


# ----------------------------- checkpoints --------------------------- #


def test_checkpoint_kill_between_staging_and_rename(tmp_path, monkeypatch):
    """l.438-471: a crash inside the rename window keeps the previous
    checkpoint restorable, and the orphaned staging dir is no step."""
    mgr = CheckpointManager(tmp_path, keep=3)
    tree = {"a": np.arange(4.0)}
    mgr.save(1, tree, extra={"cursor": 1})

    def killed_rename(src, dst):
        raise InjectedProcessKill("kill between staging write and rename")

    monkeypatch.setattr(ckpt_mod.os, "rename", killed_rename)
    with pytest.raises(InjectedProcessKill):
        mgr.save(2, {"a": np.arange(4.0) + 9}, extra={"cursor": 2})
    monkeypatch.undo()

    assert (tmp_path / "step_0000000002.tmp").exists()
    assert not (tmp_path / "step_0000000002").exists()
    assert mgr.all_steps() == [1]
    step, restored, extra = mgr.restore_latest(tree)
    assert step == 1 and extra["cursor"] == 1
    np.testing.assert_array_equal(restored["a"], tree["a"])

    mgr.save(2, {"a": np.arange(4.0) + 9}, extra={"cursor": 2})
    assert mgr.latest_step() == 2
    assert not (tmp_path / "step_0000000002.tmp").exists()


def test_checkpoint_kill_between_rename_and_latest(tmp_path, monkeypatch):
    """l.474-496: a crash before the LATEST update leaves a complete step
    that restores."""
    mgr = CheckpointManager(tmp_path, keep=3)
    tree = {"a": np.zeros(3)}
    mgr.save(1, tree)

    def killed_replace(src, dst):
        raise InjectedProcessKill("kill between rename and LATEST update")

    monkeypatch.setattr(ckpt_mod.os, "replace", killed_replace)
    with pytest.raises(InjectedProcessKill):
        mgr.save(2, tree)
    monkeypatch.undo()

    assert (tmp_path / "step_0000000002").exists()
    out = mgr.restore_latest(tree)
    assert out is not None and out[0] in (1, 2)
    assert mgr.all_steps() == [1, 2]


def _tree():
    """Nested dicts, lists and tuples of arrays and tensors."""
    return {"b": [np.arange(6, dtype=np.int64).reshape(2, 3),
                  (np.float32(1.5) * np.ones(2, np.float32),
                   torch.arange(3, dtype=torch.float64))],
            "a": {"z": np.array(True), "y": torch.tensor([7], dtype=torch.int32)},
            "c": np.full((2, 2), -0.0)}


def _extra():
    return {"fingerprint": "0123456789abcdef", "cursor": 300,
            "quarantined": [[1, "dispatch_failed after 3 retries"],
                            [70000, "non-finite"]],
            "retries": -2, "seed": 2 ** 40, "ratio": 0.25, "none": None,
            "flag": False}


def _as_numpy(tree):
    return ckpt_mod._rebuild(tree, ckpt_mod._flatten_with_names(tree))


def test_leaf_names_equal_reference():
    ref = pytest.importorskip("repro.checkpoint.ckpt")
    tree = _as_numpy(_tree())
    mine = ckpt_mod._flatten_with_names(tree)
    theirs = ref._flatten_with_names(tree)
    assert list(mine) == list(theirs)
    for name in mine:
        np.testing.assert_array_equal(mine[name], theirs[name])


def test_checkpoints_read_across_packages(tmp_path):
    """A reference checkpoint restores in the port's manager and the
    reverse; the manifests are the same bytes."""
    ref = pytest.importorskip("repro.checkpoint")
    tree = _as_numpy(_tree())
    ref.CheckpointManager(tmp_path / "ref", keep=3).save(5, tree, _extra())
    CheckpointManager(tmp_path / "port", keep=3).save(5, _tree(), _extra())
    assert ((tmp_path / "ref" / "step_0000000005" / "manifest.msgpack")
            .read_bytes()
            == (tmp_path / "port" / "step_0000000005" / "manifest.msgpack")
            .read_bytes())
    for name in ("ref", "port"):
        step, got, extra = CheckpointManager(tmp_path / name).restore_latest(
            _tree())
        step2, got2, extra2 = ref.CheckpointManager(
            tmp_path / name).restore_latest(tree)
        assert step == step2 == 5 and extra == extra2 == _extra()
        for a, b, c in zip(ckpt_mod._flatten_with_names(got).values(),
                           ckpt_mod._flatten_with_names(got2).values(),
                           ckpt_mod._flatten_with_names(tree).values()):
            assert a.dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)


def test_manifest_bytes_equal_msgpack(tmp_path):
    msgpack = pytest.importorskip("msgpack")
    save_pytree(_tree(), tmp_path / "s", extra=_extra())
    data = (tmp_path / "s" / "manifest.msgpack").read_bytes()
    manifest = msgpack.unpackb(data)
    assert msgpack.packb(manifest) == data
    assert _msgpack.unpackb(data) == manifest
    assert manifest["extra"] == _extra()
    assert sorted(manifest["leaves"]) == [
        "a/y", "a/z", "b/0", "b/1/0", "b/1/1", "c"]
    assert manifest["leaves"]["b/1/1"] == {
        "file": "b__1__1.npy", "dtype": "float64", "shape": [3]}


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63,
    1.5, -0.0, float("inf"), True, False, None, "", "a" * 31, "a" * 32,
    "a" * 256, "a" * 70000, "é", [1] * 15, [1] * 16, [0] * 70000, (1, "x"),
    {str(i): [i, None] for i in range(16)},
    {str(i): i for i in range(70000)}])
def test_msgpack_codec_equals_msgpack(value):
    msgpack = pytest.importorskip("msgpack")
    data = _msgpack.packb(value)
    assert data == msgpack.packb(value)
    assert _msgpack.unpackb(data) == msgpack.unpackb(data)


def test_msgpack_codec_refuses_what_it_does_not_cover():
    with pytest.raises(TypeError):
        _msgpack.packb({"x": np.int64(1)})
    with pytest.raises(OverflowError):
        _msgpack.packb(2 ** 64)
    with pytest.raises(ValueError):
        _msgpack.unpackb(b"\xc7\x01\x00\x00")       # ext 8
    with pytest.raises(ValueError):
        _msgpack.unpackb(b"\x01\x02")               # trailing bytes


#: The reduced-float leaf dtypes both packages store as unsigned views.
VIEW_DTYPES = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn}


def _view_leaf(dtype: torch.dtype) -> torch.Tensor:
    """A (3, 5) leaf of ``dtype`` with signed zeros, subnormals and the
    largest finite value among normal numbers."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn(3, 5, generator=g)
    w[0, :3] = torch.tensor([-0.0, 2.0 ** -9, torch.finfo(dtype).max])
    return w.to(dtype)


def _port_state(kind: str, w: torch.Tensor):
    """The port's tree of a train loop's checkpoint: ``w`` as a parameter
    and an ``OptState`` of ``kind`` over it."""
    from repro_torch.optim import OptState

    b = torch.arange(4, dtype=torch.float32)
    f32 = {"b": b + 1, "w": w.float() * 3}
    if kind == "adamw":
        opt = OptState(torch.tensor(3, dtype=torch.int32), f32,
                       {"b": b * 2, "w": w.float()},
                       {"b": b * 4, "w": w.float() ** 2})
    else:
        opt = OptState(torch.tensor(3, dtype=torch.int32), f32, None,
                       {"b": (b * 4,), "w": (w.float()[:, 0],
                                             w.float()[0])})
    return {"params": {"w": w, "b": b}, "opt": opt}


def _as_reference(tree):
    """The same tree in the reference's terms: numpy leaves (``ml_dtypes``
    for bfloat16 and float8) and the reference's ``OptState``."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    ref_optim = pytest.importorskip("repro.optim")

    def leaf(t):
        for name, dtype in VIEW_DTYPES.items():
            if t.dtype == dtype:
                bits = ckpt_mod._to_disk(t)[0]
                return bits.view(getattr(ml_dtypes, name))
        return t.numpy()

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "_fields"):
            return ref_optim.OptState(*(conv(v) for v in x))
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        return leaf(x)
    return conv(tree)


def _bits(leaf) -> np.ndarray:
    """A leaf's bits: the unsigned view of a reduced float, else the
    array itself."""
    return ckpt_mod._to_disk(leaf)[0]


@pytest.mark.parametrize("dtype", sorted(VIEW_DTYPES))
@pytest.mark.parametrize("direction", ["port_to_port", "reference_to_port",
                                       "port_to_reference"])
def test_reduced_float_leaves_round_trip(tmp_path, direction, dtype):
    """bfloat16 and float8_e4m3fn leaves, beside an ``OptState``, restore
    bit for bit within the port and across the two packages both ways,
    under the reference's manifest dtype strings and leaf names."""
    tree = _port_state("adamw", _view_leaf(VIEW_DTYPES[dtype]))
    if direction == "reference_to_port":
        ref = pytest.importorskip("repro.checkpoint")
        ref.save_pytree(_as_reference(tree), tmp_path / "s",
                        extra={"k": 1})
    else:
        save_pytree(tree, tmp_path / "s", extra={"k": 1})
    manifest = _msgpack.unpackb(
        (tmp_path / "s" / "manifest.msgpack").read_bytes())
    assert manifest["leaves"]["params/w"]["dtype"] == dtype
    assert sorted(manifest["leaves"]) == [
        "opt/.m/b", "opt/.m/w", "opt/.master/b", "opt/.master/w",
        "opt/.step", "opt/.v/b", "opt/.v/w", "params/b", "params/w"]
    if direction == "port_to_reference":
        ref = pytest.importorskip("repro.checkpoint.ckpt")
        like = _as_reference(tree)
        got, extra = ref.load_pytree(tmp_path / "s", like)
        assert type(got["opt"]).__module__ == "repro.optim.optimizers"
        got_flat = ref._flatten_with_names(got)
        want_flat = ref._flatten_with_names(like)
    else:
        like = ckpt_mod._rebuild(tree, {
            ckpt_mod._name(p): torch.zeros_like(t)
            for p, t in ckpt_mod._leaves(tree)})
        got, extra = load_pytree(tmp_path / "s", like)
        assert type(got["opt"]).__name__ == "OptState"
        assert got["params"]["w"].dtype == VIEW_DTYPES[dtype]
        got_flat = {ckpt_mod._name(p): t for p, t in ckpt_mod._leaves(got)}
        want_flat = {ckpt_mod._name(p): t
                     for p, t in ckpt_mod._leaves(tree)}
    assert extra == {"k": 1}
    assert list(got_flat) == list(want_flat)
    for name in want_flat:
        assert got_flat[name].dtype == want_flat[name].dtype, name
        np.testing.assert_array_equal(_bits(got_flat[name]),
                                      _bits(want_flat[name]), err_msg=name)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optstate_leaf_names_equal_reference(kind):
    """A NamedTuple's children are named ``.<field>`` as
    ``jax.tree_util`` names them; plain tuples keep their index; a
    ``None`` field holds no leaf."""
    ref = pytest.importorskip("repro.checkpoint.ckpt")
    tree = _port_state(kind, _view_leaf(torch.bfloat16))
    mine = ckpt_mod._flatten_with_names(tree)
    theirs = ref._flatten_with_names(_as_reference(tree))
    assert list(mine) == list(theirs)
    if kind == "adafactor":
        assert "opt/.v/w/1" in mine and not any(".m/" in n for n in mine)
    for name in mine:
        np.testing.assert_array_equal(mine[name], theirs[name].view(
            mine[name].dtype))


def test_namedtuple_rebuilds_with_its_fields(tmp_path):
    """A restored NamedTuple is built from its fields positionally."""
    tree = _port_state("adafactor", torch.ones(3, 5))
    save_pytree(tree, tmp_path / "s")
    got, _ = load_pytree(tmp_path / "s", tree)
    assert got["opt"]._fields == tree["opt"]._fields
    assert got["opt"].m is None
    assert isinstance(got["opt"].v["w"], tuple)
    torch.testing.assert_close(got["opt"].v["w"][1], tree["opt"].v["w"][1],
                               rtol=0, atol=0)


def test_keep_last_k_and_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in range(1, 5):
        mgr.save(step, {"a": np.full(2, step)})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    t = torch.arange(3, dtype=torch.float64)
    mgr.save_async(5, {"a": np.full(2, 5), "t": t}, extra={"k": 1})
    t += 100                      # the snapshot was taken at the call
    mgr.wait()
    step, tree, extra = mgr.restore_latest({"a": np.zeros(2, np.int64),
                                            "t": torch.zeros(3)})
    assert step == 5 and extra == {"k": 1}
    np.testing.assert_array_equal(tree["t"], [0.0, 1.0, 2.0])
    assert tree["t"].dtype == torch.float32     # the like leaf's dtype
    assert mgr.all_steps() == [4, 5]
