"""The streaming sweep on the card, against the reference's float64
aggregates (``tests/data/stream_golden.json``, ``tools/stream_golden.py``)
and against the port's own CPU run.

The discrete results (``mix_count``, ``slowdown_hist``, the quarantined
chunks, coverage, retries) equal the golden exactly and the float
aggregates are within rtol 1e-9 (``tests/_stream_golden.py``); kill and
resume, overlap and serial, each equal bit for bit on the card; a stream
launches the greedy kernel ``n_chunks`` times as often as one chunk's
``run_timelines`` does, and more than never.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_*.py``.  The file imports neither JAX nor the JAX
package.
"""
import numpy as np
import pytest
import torch

from _stream_golden import (
    RECORD_CBP_GEOMEAN,
    check_run,
    load,
    port_config,
    port_plan,
)

from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.runtime.faultinject import (
    FaultPlan,
    FaultSpec,
    InjectedProcessKill,
)
from repro_torch.sim import timeline
from repro_torch.sim.apps import from_numpy
from repro_torch.sim.stream_sweep import _build_specs, run_stream
from repro_torch.sim.workloads import scenario_chunk

pytestmark = pytest.mark.cuda

GOLDEN = load()
_NO_SLEEP = lambda s: None  # noqa: E731


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this file runs the stream and "
                    "its greedy kernel on the card")


def _trees_equal(a, b):
    ta, tb = a.aggregates.to_tree(), b.aggregates.to_tree()
    return all(np.array_equal(ta[k], tb[k], equal_nan=True) for k in ta)


def _healthy(report):
    assert report.coverage == 1.0 and report.retries == 0
    assert report.quarantined == []


@pytest.mark.parametrize("run", ["healthy", "faults"])
def test_bench_smoke_matches_golden(card, run):
    g = GOLDEN["bench_smoke"]
    report = run_stream(port_config(g["config"]),
                        fault_plan=port_plan(g["runs"][run]),
                        sleep_fn=_NO_SLEEP, device="cuda")
    check_run(report, g["runs"][run], f"bench_smoke/{run}")
    if run == "healthy":
        _healthy(report)
        assert report.geomean_ws["CBP"] == RECORD_CBP_GEOMEAN


def test_kill_and_resume_on_the_card(card, tmp_path):
    g = GOLDEN["bench_smoke"]
    cfg = port_config(g["config"], checkpoint_dir=str(tmp_path / "ck"),
                      checkpoint_every=1)
    plan = FaultPlan((FaultSpec("dispatch_error", 0, count=1),
                      FaultSpec("nan_poison", 1), FaultSpec("kill", 2)))
    with pytest.raises(InjectedProcessKill):
        run_stream(cfg, fault_plan=plan, sleep_fn=_NO_SLEEP, device="cuda")
    resumed = run_stream(cfg, fault_plan=plan.without_kills(), resume=True,
                         sleep_fn=_NO_SLEEP, device="cuda")
    clean = run_stream(port_config(g["config"]),
                       fault_plan=plan.without_kills(), sleep_fn=_NO_SLEEP,
                       device="cuda")
    assert resumed.resumed_from is not None
    assert _trees_equal(resumed, clean)
    assert [c for c, _ in resumed.quarantined] == [1]
    assert resumed.coverage == 0.75 and resumed.retries >= 1
    check_run(clean, g["runs"]["faults"], "bench_smoke/faults")


def test_overlap_equals_serial(card):
    cfg = port_config(GOLDEN["bench_smoke"]["config"])
    overlapped = run_stream(cfg, overlap=True, device="cuda")
    serial = run_stream(cfg, overlap=False, device="cuda")
    _healthy(overlapped)
    _healthy(serial)
    assert _trees_equal(overlapped, serial)


def test_device_none_runs_on_the_card(card):
    g = GOLDEN["tests"]
    report = run_stream(port_config(g["config"]))
    _healthy(report)
    check_run(report, g["runs"]["healthy"], "tests/healthy, device=None")


def test_greedy_launch_rule(card):
    """A stream launches n_chunks times one chunk's run_timelines, > 0."""
    cfg = port_config(GOLDEN["bench_smoke"]["config"])
    params = scenario_chunk(cfg.scenario, cfg.seed, 0, cfg.chunk_size)
    params.pop("mix_indices")
    torch.cuda.synchronize()
    reset_launch_counts()
    timeline.run_timelines_async(
        from_numpy(params, torch.device("cuda")),
        _build_specs(cfg, cfg.scenario.apps_per_mix),
        total_units=cfg.total_cache_units,
        total_bandwidth=cfg.total_bandwidth).block_until_ready()
    one = launch_counts()["lookahead_greedy"]
    assert one > 0
    reset_launch_counts()
    report = run_stream(cfg, device="cuda")
    _healthy(report)
    assert launch_counts()["lookahead_greedy"] == one * cfg.n_chunks


@pytest.mark.parametrize("run", ["healthy", "faults"])
def test_card_equals_cpu_run(card, run):
    """The ``tests`` case on the card against the port's CPU run: counts
    exact, floats within rtol 1e-9."""
    g = GOLDEN["tests"]
    plan = port_plan(g["runs"][run])
    cpu = run_stream(port_config(g["config"]), fault_plan=plan,
                     sleep_fn=_NO_SLEEP, device="cpu")
    gpu = run_stream(port_config(g["config"]), fault_plan=plan,
                     sleep_fn=_NO_SLEEP, device="cuda")
    as_run = {"aggregates": cpu.aggregates.to_tree(),
              "quarantined": [c for c, _ in cpu.quarantined],
              "report": {"coverage": cpu.coverage,
                         "mixes_covered": cpu.mixes_covered,
                         "retries": cpu.retries}}
    check_run(gpu, as_run, f"tests/{run}: card vs CPU")
    check_run(gpu, g["runs"][run], f"tests/{run}: card vs golden")
