"""The streaming sweep service of the port on the CPU
(``repro_torch.sim.stream_sweep.run_stream(..., device="cpu")``).

Every stream test of ``tests/test_stream_sweep.py`` (l.251-433) runs here
on the port with the same configurations and faults; the reference's
budget of 3 device programs a chunk becomes the port's greedy rule: a
stream calls the Lookahead greedy ``n_chunks`` times as often as one
chunk's ``run_timelines`` does, and more than never.  The service is held
to the reference's float64 aggregates (``tests/data/stream_golden.json``,
``tools/stream_golden.py``): ``mix_count``, ``slowdown_hist``, the
quarantined chunks, coverage and retries exactly, the float aggregates
within rtol 1e-9 (``tests/_stream_golden.py``); ``fingerprint()`` equals
the reference's; overlap, resume and retry each equal the uninterrupted
serial run bit for bit; the committed golden's ``tests`` case is
regenerated in a float64 JAX subprocess and must equal the file.
"""
import numpy as np
import pytest
import torch

from _stream_golden import (
    CARD_CASES,
    RECORD_CBP_GEOMEAN,
    check_run,
    load,
    port_config,
    port_plan,
)
from _torch_jax_ref import jax_reference

from repro_torch.core import cache_controller
from repro_torch.runtime.faultinject import (
    FaultPlan,
    FaultSpec,
    InjectedProcessKill,
)
from repro_torch.sim import memsys, timeline
from repro_torch.sim.apps import from_numpy
from repro_torch.sim.runner import equal_share
from repro_torch.sim.stream_sweep import (
    CheckpointMismatchError,
    NumericalDivergenceError,
    RetryPolicy,
    StreamAbortedError,
    StreamConfig,
    _build_specs,
    run_stream,
)
from repro_torch.sim.workloads import StreamScenario, scenario_chunk

_NO_SLEEP = lambda s: None  # noqa: E731 — backoff must not slow tests

GOLDEN = load()
GOLDEN_RUNS = [(case, run) for case, g in GOLDEN.items()
               if case not in CARD_CASES for run in g["runs"]]


def _cfg(**kw):
    base = dict(
        n_mixes=16, chunk_size=4, managers=("baseline", "CBP"),
        total_ms=20.0, seed=7,
        scenario=StreamScenario(apps_per_mix=6),
    )
    base.update(kw)
    return StreamConfig(**base)


def _run(cfg, **kw):
    return run_stream(cfg, device="cpu", **kw)


def _trees_equal(a, b):
    ta, tb = a.aggregates.to_tree(), b.aggregates.to_tree()
    return all(np.array_equal(ta[k], tb[k], equal_nan=True) for k in ta)


@pytest.fixture
def greedy_calls(monkeypatch):
    """Counts the calls of the Lookahead greedy's wrapper (on the CPU the
    launch counter stays at 0: the wrapper runs the plain version)."""
    calls = []
    real = cache_controller.lookahead_greedy

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(cache_controller, "lookahead_greedy", counted)
    return calls


@pytest.fixture(scope="module")
def healthy():
    """The ``_cfg()`` stream, overlapped and serial."""
    return _run(_cfg(), overlap=True), _run(_cfg(), overlap=False)


# ---------------------------- the golden ---------------------------- #


@pytest.mark.parametrize("case,run", GOLDEN_RUNS)
def test_matches_reference_golden(case, run):
    g = GOLDEN[case]
    report = _run(port_config(g["config"]), fault_plan=port_plan(
        g["runs"][run]), sleep_fn=_NO_SLEEP)
    check_run(report, g["runs"][run], f"{case}/{run}")
    if run == "healthy":
        assert report.coverage == 1.0 and report.retries == 0
        assert report.quarantined == []
    if (case, run) == ("bench_smoke", "healthy"):
        assert report.geomean_ws["CBP"] == RECORD_CBP_GEOMEAN


@pytest.mark.parametrize("case", list(GOLDEN))
def test_fingerprint_equals_reference(case):
    cfg = port_config(GOLDEN[case]["config"])
    assert cfg.fingerprint() == GOLDEN[case]["fingerprint"]


def test_fingerprint_equals_reference_in_process():
    ref = pytest.importorskip("repro.sim.stream_sweep")
    from repro.sim.workloads import StreamScenario as RefScenario

    for kw in ({}, {"seed": 8, "chunk_size": 16},
               {"managers": None, "total_ms": 33.0,
                "checkpoint_every": 2}):
        base = dict(n_mixes=16, chunk_size=4, managers=("baseline", "CBP"),
                    total_ms=20.0, seed=7)
        base.update(kw)
        mine = StreamConfig(**base, scenario=StreamScenario(
            apps_per_mix=6, popularity="zipf"))
        theirs = ref.StreamConfig(**base, scenario=RefScenario(
            apps_per_mix=6, popularity="zipf"))
        assert mine.fingerprint() == theirs.fingerprint()


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    return jax_reference("stream", tmp_path_factory)


def test_committed_golden_is_the_reference(jax_stream):
    """The ``tests`` case regenerated in a float64 JAX subprocess equals
    the committed file exactly."""
    ref = jax_stream
    for run, want in GOLDEN["tests"]["runs"].items():
        for key, a in want["aggregates"].items():
            assert np.array_equal(ref[f"{run}|{key}"], a), (run, key)
        assert ref[f"{run}|quarantined"].tolist() == want["quarantined"]
        assert int(ref[f"{run}|retries"]) == want["report"]["retries"]


# ----------------------- stream service core ------------------------ #


def test_stream_overlap_matches_serial_bitwise(healthy):
    r_overlap, r_serial = healthy
    assert _trees_equal(r_overlap, r_serial)
    assert r_overlap.coverage == 1.0 and r_overlap.quarantined == []
    assert r_overlap.retries == 0 and r_serial.retries == 0
    # "baseline" manager IS the equal-share reference: geomean ws == 1
    assert abs(r_overlap.geomean_ws["baseline"] - 1.0) < 1e-9
    assert r_overlap.geomean_ws["CBP"] > 1.0
    assert 0.0 < r_overlap.min_fairness["CBP"] <= 1.0


def test_stream_chunk_size_is_part_of_stream_identity(tmp_path):
    assert (_cfg(chunk_size=4).fingerprint()
            != _cfg(chunk_size=16).fingerprint())
    ckpt = str(tmp_path / "ck")
    _run(_cfg(checkpoint_dir=ckpt))
    with pytest.raises(CheckpointMismatchError):
        _run(_cfg(checkpoint_dir=ckpt, chunk_size=16), resume=True)


def test_stream_matches_direct_reference(healthy):
    """The online fold reproduces a direct evaluation of the same stream
    (the port's own run_timelines and baseline, every chunk at once)."""
    cfg = _cfg()
    report = healthy[1]
    n = cfg.scenario.apps_per_mix
    specs = _build_specs(cfg, n)
    ws_all = {name: [] for name in cfg.manager_names}
    for c in range(cfg.n_chunks):
        params = scenario_chunk(cfg.scenario, cfg.seed, c, cfg.chunk_size)
        params.pop("mix_indices")
        p = from_numpy(params, torch.device("cpu"))
        results = timeline.run_timelines(
            p, specs, total_units=cfg.total_cache_units,
            total_bandwidth=cfg.total_bandwidth)
        units, bw = equal_share(n, cfg.total_cache_units,
                                cfg.total_bandwidth)
        base = memsys.evaluate(
            p, np.tile(units.astype(np.float64), (cfg.chunk_size, 1)),
            np.tile(bw, (cfg.chunk_size, 1)),
            np.zeros((cfg.chunk_size, n), dtype=bool),
            cache_partitioned=False, bandwidth_partitioned=False,
            total_cache_units=float(cfg.total_cache_units),
            total_bandwidth_gbps=cfg.total_bandwidth).ipc.numpy()
        for name, res in zip(cfg.manager_names, results):
            ipc = res.ipc_acc / res.w_acc
            ws_all[name].append((ipc / base).mean(axis=-1))
    for name in cfg.manager_names:
        ref = np.exp(np.mean(np.log(np.concatenate(ws_all[name]))))
        assert abs(report.geomean_ws[name] - ref) < 1e-6, name


def test_stream_greedy_budget(greedy_calls):
    """The port's budget in place of the reference's 3 programs a chunk:
    the stream calls the greedy exactly n_chunks times as often as one
    chunk's run_timelines, on the same rows, and more than never."""
    cfg = _cfg()
    params = scenario_chunk(cfg.scenario, cfg.seed, 0, cfg.chunk_size)
    params.pop("mix_indices")
    timeline.run_timelines_async(
        from_numpy(params, torch.device("cpu")),
        _build_specs(cfg, cfg.scenario.apps_per_mix),
        total_units=cfg.total_cache_units,
        total_bandwidth=cfg.total_bandwidth)
    one_chunk = list(greedy_calls)
    assert len(one_chunk) > 0
    del greedy_calls[:]
    report = _run(cfg)
    assert report.coverage == 1.0 and report.retries == 0
    assert greedy_calls == one_chunk * cfg.n_chunks


# ------------------------- fault classes ---------------------------- #


def test_stream_retry_then_success_bit_identical(healthy):
    slept = []
    plan = FaultPlan.single("dispatch_error", 1, count=2)
    r = _run(_cfg(), fault_plan=plan, sleep_fn=slept.append)
    assert r.retries == 2 and r.coverage == 1.0 and r.quarantined == []
    assert slept == [RetryPolicy().delay(0), RetryPolicy().delay(1)]
    assert _trees_equal(r, healthy[0])  # recovery leaves no trace


def test_stream_dispatch_exhaustion_quarantines():
    plan = FaultPlan.single("dispatch_error", 2, count=99)
    r = _run(_cfg(), fault_plan=plan, sleep_fn=_NO_SLEEP)
    assert [c for c, _ in r.quarantined] == [2]
    assert "dispatch_failed" in r.quarantined[0][1]
    assert "InjectedDispatchError" in r.quarantined[0][1]
    assert r.coverage == 12 / 16 and r.mixes_covered == 12


def test_stream_nan_poison_quarantined_with_named_culprit():
    plan = FaultPlan.single("nan_poison", 1)
    r = _run(_cfg(), fault_plan=plan, sleep_fn=_NO_SLEEP)
    assert [c for c, _ in r.quarantined] == [1]
    reason = r.quarantined[0][1]
    assert "baseline" in reason and "mix 4" in reason  # manager + global mix
    assert r.coverage == 12 / 16


def test_stream_nan_poison_raise_mode():
    plan = FaultPlan.single("nan_poison", 0)
    with pytest.raises(NumericalDivergenceError) as exc:
        _run(_cfg(on_divergence="raise"), fault_plan=plan,
             sleep_fn=_NO_SLEEP)
    assert exc.value.manager == "baseline"
    assert exc.value.chunk_index == 0 and exc.value.mix_index == 0


def test_stream_aborts_on_consecutive_quarantines():
    plan = FaultPlan((FaultSpec("nan_poison", 0), FaultSpec("nan_poison", 1),
                      FaultSpec("nan_poison", 2)))
    with pytest.raises(StreamAbortedError):
        _run(_cfg(max_consecutive_quarantines=2), fault_plan=plan,
             sleep_fn=_NO_SLEEP)


def test_stream_straggle_feeds_watchdog():
    plan = FaultPlan((FaultSpec("straggle", 2, seconds=50.0),
                      FaultSpec("straggle", 3, seconds=50.0)))
    r = _run(_cfg(watchdog_warmup=1, watchdog_threshold=3.0),
             fault_plan=plan, sleep_fn=_NO_SLEEP)
    assert r.straggler_events == 2
    assert r.coverage == 1.0  # slow is not wrong: no quarantine


@pytest.mark.parametrize("overlap", [True, False])
def test_stream_kill_resume_bit_parity(tmp_path, overlap):
    """Dispatch failure retried, a poisoned chunk quarantined, a kill
    mid-run, resume: final aggregates bit-identical to the same-seed
    uninterrupted run with the same surviving faults."""
    ckpt = str(tmp_path / "ck")
    cfg = _cfg(checkpoint_dir=ckpt, checkpoint_every=1)
    plan = FaultPlan((FaultSpec("dispatch_error", 0, count=1),
                      FaultSpec("nan_poison", 1),
                      FaultSpec("kill", 2)))
    with pytest.raises(InjectedProcessKill):
        _run(cfg, fault_plan=plan, sleep_fn=_NO_SLEEP, overlap=overlap)
    resumed = _run(cfg, fault_plan=plan.without_kills(), resume=True,
                   sleep_fn=_NO_SLEEP, overlap=overlap)
    assert resumed.resumed_from is not None
    clean = _run(_cfg(), fault_plan=plan.without_kills(),
                 sleep_fn=_NO_SLEEP, overlap=False)
    assert _trees_equal(resumed, clean)
    assert resumed.coverage == clean.coverage == 12 / 16
    assert [c for c, _ in resumed.quarantined] == [1]
    assert resumed.retries >= 1
    check_run(clean, GOLDEN["tests"]["runs"]["faults"], "tests/faults")


def test_stream_resume_refuses_foreign_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ck")
    _run(_cfg(checkpoint_dir=ckpt))
    with pytest.raises(CheckpointMismatchError):
        _run(_cfg(checkpoint_dir=ckpt, seed=8), resume=True)


def test_stream_checkpoint_cadence(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    ckpt = tmp_path / "ck"
    _run(_cfg(checkpoint_dir=str(ckpt), checkpoint_every=2))
    mgr = CheckpointManager(ckpt, keep=3)
    assert mgr.latest_step() == 4  # n_chunks, i.e. the stream completed
    assert mgr.all_steps() == [2, 4]  # cadence 2, keep-last-k pruned


def test_stream_resumes_from_a_reference_checkpoint(jax_stream):
    """A checkpoint the reference's float64 stream wrote before it was
    killed at chunk 2 resumes in the port's (same layout, fingerprint and
    manifest) to the uninterrupted reference's aggregates.  The overlapped
    reference had chunk 1 in flight at the kill: its last checkpoint holds
    chunk 0."""
    resumed = _run(_cfg(checkpoint_dir=str(jax_stream["ckpt_dir"]),
                        checkpoint_every=1), resume=True)
    assert resumed.resumed_from == 1
    check_run(resumed, GOLDEN["tests"]["runs"]["healthy"], "resumed")


def test_stream_config_validation():
    with pytest.raises(ValueError):
        _cfg(managers=("CBP", "nonsense"))
    with pytest.raises(ValueError):
        _cfg(on_divergence="explode")
    with pytest.raises(ValueError):
        _cfg(n_mixes=0)
    assert _cfg(n_mixes=10, chunk_size=4).n_chunks == 3
    assert _cfg().fingerprint() != _cfg(seed=8).fingerprint()
    assert _cfg().fingerprint() == _cfg().fingerprint()


# ------------------------ run_timelines_async ------------------------ #


def test_run_timelines_async_result_equals_run_timelines():
    cfg = _cfg(managers=None)
    params = scenario_chunk(cfg.scenario, cfg.seed, 1, cfg.chunk_size)
    params.pop("mix_indices")
    p = from_numpy(params, torch.device("cpu"))
    specs = _build_specs(cfg, cfg.scenario.apps_per_mix)
    kw = dict(total_units=cfg.total_cache_units,
              total_bandwidth=cfg.total_bandwidth)
    pending = timeline.run_timelines_async(p, specs, **kw)
    assert pending.event is None            # the CPU records no event
    assert pending.block_until_ready() is pending
    got = pending.result()
    want = timeline.run_timelines(p, specs, **kw)
    assert len(got) == len(want) == len(specs)
    for g, w, dev, w_acc in zip(got, want, pending.device_results,
                                pending.w_accs):
        assert g.w_acc == w.w_acc == w_acc
        for f in ("ipc_acc", "cache_units", "bandwidth", "prefetch_on",
                  "active"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        # the per-spec device views hold the same values
        np.testing.assert_array_equal(dev["ipc_acc"].numpy(), w.ipc_acc)
        np.testing.assert_array_equal(dev["cache_units"].numpy(),
                                      w.cache_units)


def _cli():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "torch_stream_sweep.py"
    spec = importlib.util.spec_from_file_location("torch_stream_sweep", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def test_cli_reports_and_exits_on_coverage(tmp_path, capsys):
    """The CLI's exit rule: 0 at full coverage, 1 below --min-coverage."""
    import json

    cli = _cli()
    argv = ["--mixes", "8", "--chunk-size", "4", "--managers", "baseline,CBP",
            "--total-ms", "20", "--seed", "7", "--apps-per-mix", "6",
            "--device", "cpu", "--out", str(tmp_path / "r.json")]
    assert cli.main(argv + ["--overlap"]) == 0
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["coverage"] == 1.0 and report["run"]["device"] == "cpu"
    assert len(report["config"]["fingerprint"]) == 16
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([{"kind": "nan_poison", "chunk": 1}]))
    assert cli.main(argv + ["--fault-plan", str(plan)]) == 1
    assert "coverage 0.5000" in capsys.readouterr().err


def test_run_stream_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_stream(_cfg())
