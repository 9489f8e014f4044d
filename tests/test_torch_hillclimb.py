"""The port's §Perf hill-climb harness (``repro_torch.launch.hillclimb``)
against the reference's ``tools/hillclimb.py``.

Held:

* its ``CELLS`` and ``VARIANTS`` equal the reference's (read from
  ``tools/hillclimb.py``, whose top level imports only the standard
  library);
* ``--fig5-seed`` on the CPU, in both seed modes, at
  :data:`N_WORKLOADS` workloads and :data:`K` seeds: each workload's
  climbed allocation equals the reference's climb (run in a subprocess,
  JAX on the CPU in float64, its record's rows unrounded) and its weighted
  speedup within rtol 1e-9; where an allocation differs, the two must tie
  within 1e-9 under the reference's numpy model, and the test says so;
* the Fig. 5 record's keys, its cache by parameters, and the CLI;
* one cheap ``run_variant`` record (``dense_decode`` / ``v1_onehot``):
  ``ok``, with the reference's record keys (``trace_s`` where the
  reference has ``compile_s``).

The card's climb against the CPU's is ``tests/test_torch_hillclimb_cuda.py``.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import hillclimb as H

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "tools" / "hillclimb.py"
N_WORKLOADS, K = 2, 2
MODES = ("scalar", "multi")
RTOL = 1e-9

REF_SCRIPT = r'''
import importlib.util, json, pathlib, sys
spec = importlib.util.spec_from_file_location("hillclimb_ref", sys.argv[1])
hc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(hc)
hc.OUT = pathlib.Path(sys.argv[2])
hc.round = lambda x, n=None: x      # the record's rows unrounded
out = {mode: hc.fig5_seeded_hillclimb(
           int(sys.argv[3]), int(sys.argv[4]), force=True,
           multi_objective=mode == "multi")["rows"]
       for mode in ("scalar", "multi")}
json.dump(out, open(sys.argv[5], "w"))
'''


def _reference_module():
    spec = importlib.util.spec_from_file_location("hillclimb_ref", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def climbs(tmp_path_factory):
    """The reference's climb in a subprocess, the port's in this one."""
    tmp = tmp_path_factory.mktemp("hillclimb")
    out = tmp / "reference.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "JAX_ENABLE_X64": "1",
           "HOME": str(tmp), "TMPDIR": str(tmp), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(REFERENCE), str(tmp / "perf"),
         str(N_WORKLOADS), str(K), str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # small tensors: threads only contend
    try:
        port = {mode: H.climb_rows(N_WORKLOADS, K, mode == "multi", "cpu")
                for mode in MODES}
    finally:
        torch.set_num_threads(threads)
    _, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-4000:]
    return {"port": port, "reference": json.loads(out.read_text())}


def _ws(workload, config) -> float:
    """The weighted speedup of ``config`` under the reference's numpy
    model, as its climb scores it."""
    from repro.sim import memsys
    from repro.sim.apps import stack
    from repro.sim.runner import equal_share
    from repro.sim.static_search import (FIG5_FAMILIES, StaticOptions,
                                         family_grid)

    n = len(workload)
    grid = family_grid(FIG5_FAMILIES[H.FIG5_FAMILY], n, StaticOptions())
    arr = stack(workload)
    units, bw = equal_share(n, grid.total_cache_units,
                            grid.total_bandwidth_gbps)
    base = memsys.evaluate(
        arr, units.astype(np.float64), bw, np.zeros(n),
        total_cache_units=grid.total_cache_units,
        total_bandwidth_gbps=grid.total_bandwidth_gbps, iters=40).ipc
    ss = memsys.evaluate(
        arr, np.asarray(config["cache_units"]),
        np.asarray(config["bandwidth_gbps"]),
        np.asarray(config["prefetch_on"]),
        total_cache_units=grid.total_cache_units,
        total_bandwidth_gbps=grid.total_bandwidth_gbps, iters=40)
    return float(np.mean(ss.ipc / base))


def test_cells_and_variants_equal_the_reference():
    ref = _reference_module()
    assert H.CELLS == ref.CELLS
    assert H.VARIANTS == ref.VARIANTS
    assert sum(len(v) for v in H.VARIANTS.values()) == 17


@pytest.mark.parametrize("mode", MODES)
def test_fig5_climb_equals_the_reference(climbs, mode):
    got, want = climbs["port"][mode], climbs["reference"][mode]
    assert len(got) == len(want) == N_WORKLOADS
    for g, w in zip(got, want):
        assert g["workload"] == w["workload"]
        assert np.isclose(g["grid_best_ws"], w["grid_best_ws"], rtol=RTOL,
                          atol=0)
        if g["config"] != w["config"]:
            a, b = _ws(g["workload"], g["config"]), _ws(w["workload"],
                                                        w["config"])
            print(f"fig5 climb ({mode}) {g['workload']}: the port climbed "
                  f"to {g['config']}, the reference to {w['config']}; "
                  f"they tie under the reference's model ({a} / {b})")
            assert abs(a - b) <= RTOL * abs(b)
        assert np.isclose(g["refined_ws"], w["refined_ws"], rtol=RTOL,
                          atol=0), (g["refined_ws"], w["refined_ws"])
        assert g["refined_ws"] >= g["grid_best_ws"] - RTOL


def test_fig5_record_cache_and_cli(climbs, tmp_path, monkeypatch):
    rows = climbs["port"]["multi"]
    monkeypatch.setattr(H, "climb_rows", lambda *a: rows)
    rec = H.fig5_seeded_hillclimb(N_WORKLOADS, K, multi_objective=True,
                                  device="cpu", results_dir=tmp_path)
    assert set(rec) == {"family", "n_workloads", "k_seeds", "seed_mode",
                        "mean_refine_gain", "rows"}
    assert (rec["n_workloads"], rec["k_seeds"], rec["seed_mode"]) \
        == (N_WORKLOADS, K, "pareto_knee")
    for r, raw in zip(rec["rows"], rows):
        assert set(r) == {"workload", "grid_best_ws", "refined_ws",
                          "refine_gain", "config"}
        assert r["refined_ws"] == round(raw["refined_ws"], 4)
    path = tmp_path / "fig5_hillclimb__cpu.json"
    path.write_text(json.dumps({**rec, "sentinel": 1}))
    assert H.fig5_seeded_hillclimb(N_WORKLOADS, K, multi_objective=True,
                                   device="cpu", results_dir=tmp_path
                                   )["sentinel"] == 1
    # another seed mode is another record
    assert "sentinel" not in H.fig5_seeded_hillclimb(
        N_WORKLOADS, K, device="cpu", results_dir=tmp_path)
    assert H.main(["--fig5-seed", "--workloads", str(N_WORKLOADS),
                   "--seeds", str(K), "--device", "cpu", "--results",
                   str(tmp_path)]) == 0


def test_run_variant_record(tmp_path):
    rec = H.run_variant("dense_decode", "v1_onehot", device="cpu",
                        results_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == {
        "cell", "variant", "note", "overrides", "microbatches", "status",
        "trace_s", "compute_s", "memory_s", "collective_s", "dominant",
        "bound_s", "roofline_fraction", "useful_ratio", "peak_gib",
        "collective_bytes"}
    assert rec["overrides"] == H.VARIANTS["dense_decode"]["v1_onehot"][0]
    assert rec["microbatches"] == 1
    assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"],
                                 rec["collective_s"])
    assert 0 < rec["peak_gib"] < 80
    assert json.loads((tmp_path / "dense_decode__v1_onehot__cpu.json")
                      .read_text()) == rec
