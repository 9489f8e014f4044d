"""The port's dry run (``repro_torch.launch.dryrun``) and its op-cost
counter (``repro_torch.launch.op_costs``) against the JAX package's
``launch/dryrun.py`` and ``launch/hlo_parse.py``.

Five subprocesses run side by side, each once for the module:

* the reference (``tests/_torch_dryrun_ref.py``, JAX on 4 forced host
  devices): every cell's record as its ``run_cell`` starts it, its
  arithmetic, the ring model, ``CostSummary.add`` and the parsed HLO of
  a jitted prefill;
* the port on fake process groups (``tests/_torch_dryrun_run.py``):
  counted steps of qwen3-8b's smoke config on (2, 2), (1, 1) and (4, 1)
  meshes, ``make_mesh`` on a fake group, and ``run_cell`` on one cheap
  full cell (whisper-tiny ``decode_32k``, single pod, ``device="cpu"``);
  in a second process, a MoE step on a (2, 4) group and zamba2-7b's
  steps watched for what PyTorch 2.11 lacks;
* the same smoke train step on a real (2, 2) mesh of 4 gloo processes
  (``tests/_torch_mesh_run.py``'s ranks, each wait of the group bounded);
* the CLI, ``python -m repro_torch.launch.dryrun`` on the cheap cell.

Held, each exactly unless said:

(i)   for all 80 cells (10 configs x 4 shapes x 2 meshes): the record's
      arch, shape, mesh, chips, kind, params and active params, the skip
      and its reason, ``default_microbatches``, the optimizer,
      ``model_flops`` and ``memory.analytic`` (nothing compiled);
(ii)  ``DTYPE_BYTES``, the kind names, the ring model's wire bytes for
      each kind and ``CostSummary.add``;
(iii) the fake (2, 2) group counts the gloo run's collectives, kind by
      kind, with their bytes and wire bytes (and the same FLOPs);
(iv)  the global FLOPs on (2, 2) equal ``FlopCounterMode``'s count of
      the step without a mesh; per device on (1, 1) they equal it too,
      and on a pure-data (4, 1) mesh they equal the count without a mesh
      at a quarter of the batch (train and prefill);
(v)   the prefill's per-device FLOPs on (2, 2) within 1 % of
      ``hlo_parse.analyze``'s for the reference's jitted prefill, nothing
      taken out, and the four devices' FLOPs of the train step and the
      prefill within 1 % of the count without a mesh; the collectives of
      both are printed;
(v')  the mesh faults repaired: the train step's loss builds no tensor
      that spans the vocabulary and its peak estimate falls; few big
      experts train at one row a rank on a (2, 4) fake group; zamba2-7b
      asks PyTorch 2.11 for no ``Shard -> Partial``;
(vi)  ``run_cell``'s record, its cache and ``force``, an error recorded
      as data (and the CLI's exit 1 over it), the skip of a
      full-attention ``long_500k``, ``make_mesh`` on a fake group with
      its refusals, and the CLI on the cheap cell.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_dryrun_ref as ref
import _torch_dryrun_run as run

from repro_torch import configs
from repro_torch.launch import dryrun, op_costs
from repro_torch.models.model import SHAPES, ShapeSpec
from repro_torch.train import TrainStepConfig, build_train_step

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
MESHES = ("single", "multi")
CELLS = [(m, a, s) for m in MESHES for a in configs.names() for s in SHAPES]
GLOO_CASE = {"name": "train", "arch": "qwen3-8b", "rows": 8, "seq": 32,
             "microbatches": 2, "seq_shard": "train" in run.SEQ_SHARDED}


def _env(tmp: Path) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "HOME": str(tmp), "TMPDIR": str(tmp), "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The five subprocesses, started together and waited for."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = _env(tmp)
    fake_out, gloo_out = tmp / "fake.json", tmp / "gloo.pt"
    faults_out = tmp / "faults.json"
    cli_dir = tmp / "cli"
    procs = {
        "fake": subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_dryrun_run.py"),
             str(fake_out), str(tmp / "records")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "faults": subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_dryrun_run.py"),
             str(faults_out), "faults"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "gloo": subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_mesh_run.py"),
             json.dumps({"mesh": [2, 2], "timeout": 60,
                         "count": [GLOO_CASE]}), str(gloo_out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             run.CELL[0], "--shape", run.CELL[1], "--mesh", run.CELL[2],
             "--device", "cpu", "--results", str(cli_dir)],
            env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
    }
    out = {"reference": ref.reference()}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
        out[name] = {"code": proc.returncode, "stdout": stdout,
                     "stderr": stderr[-4000:]}
    assert out["fake"]["code"] == 0, out["fake"]["stderr"]
    assert out["faults"]["code"] == 0, out["faults"]["stderr"]
    assert out["gloo"]["code"] == 0, out["gloo"]["stderr"]
    out["fake"].update(json.loads(fake_out.read_text()))
    out["fake"].update(json.loads(faults_out.read_text()))
    out["gloo"]["count"] = torch.load(gloo_out, weights_only=False)
    out["cli"]["records"] = sorted(p.name for p in cli_dir.glob("*.json"))
    return out


def _reference_cell(runs, mesh, arch, shape) -> dict:
    i = CELLS.index((mesh, arch, shape))
    cell = runs["reference"]["cells"][i]
    assert (cell["record"]["mesh"], cell["record"]["arch"],
            cell["record"]["shape"]) == (mesh, arch, shape)
    return cell


# ---------------------------------------------------------------- (i) --


@pytest.mark.parametrize("mesh,arch,shape", CELLS,
                         ids=["|".join(c) for c in CELLS])
def test_cell_arithmetic_equals_the_reference(runs, mesh, arch, shape):
    want = _reference_cell(runs, mesh, arch, shape)
    cfg, rec = dryrun.start_record(arch, shape, mesh, "cpu")
    got = {k: v for k, v in rec.items() if k != "device"}
    if want["record"]["status"] == "skip":
        assert got == want["record"]
    else:   # the reference stopped before its build; the port's is pending
        assert got["status"] == "pending"
        assert ({k: v for k, v in got.items() if k != "status"}
                == {k: v for k, v in want["record"].items()
                    if k != "status"})
    spec = SHAPES[shape]
    optimizer = dryrun.OPTIMIZER.get(arch, "adamw")
    assert dryrun.default_microbatches(cfg, shape) == want["microbatches"]
    assert optimizer == want["optimizer"]
    assert dryrun.model_flops(cfg, spec, rec["chips"]) \
        == want["model_flops"]
    assert dryrun.analytic_memory(cfg, spec, rec["chips"], optimizer) \
        == want["analytic"]


# --------------------------------------------------------------- (ii) --


def test_dtype_bytes_and_kinds_equal_hlo_parse(runs):
    assert op_costs.DTYPE_BYTES == runs["reference"]["dtype_bytes"]
    assert list(op_costs.COLLECTIVES) == runs["reference"]["collectives"]
    assert set(op_costs.KINDS.values()) <= set(op_costs.COLLECTIVES)


@pytest.mark.parametrize("case", range(len(ref.WIRE_CASES)),
                         ids=[f"{k}-{n}-{g}" for k, n, g in ref.WIRE_CASES])
def test_ring_model_equals_hlo_parse(runs, case):
    want = runs["reference"]["wire"][case]
    nbytes = 4.0 * want["elements"]
    assert nbytes == want["bytes"]
    assert op_costs.wire_bytes(want["kind"], nbytes, want["group"]) \
        == want["wire"]


def test_cost_summary_add_equals_hlo_parse(runs):
    total = op_costs.CostSummary()
    for _ in range(3):
        total.add(op_costs.CostSummary(**ref.ADD_CASE), times=2.5)
    got = dataclasses.asdict(total)
    got["total_collective_bytes"] = total.total_collective_bytes
    want = runs["reference"]["add"]
    assert {k: got[k] for k in want} == want
    assert (got["flops_global"], got["all_to_all_as_all_gather"]) == (0, 0)


# -------------------------------------------------------------- (iii) --


def test_fake_group_counts_the_gloo_collectives(runs):
    fake = runs["fake"]["count"]["train|2x2"]["cost"]
    gloo = runs["gloo"]["count"]["train"]["cost"]
    assert fake["collective_count"] == gloo["collective_count"]
    assert fake["collective_bytes"] == gloo["collective_bytes"]
    assert fake["collective_wire_bytes"] == gloo["collective_wire_bytes"]
    assert fake["all_to_all_as_all_gather"] \
        == gloo["all_to_all_as_all_gather"] > 0   # a "cpu" mesh's fallback
    assert set(fake["collective_count"]) <= set(op_costs.COLLECTIVES)
    assert (fake["flops"], fake["flops_global"]) \
        == (gloo["flops"], gloo["flops_global"])


# --------------------------------------------------------------- (iv) --


def no_mesh_flops(name: str, data: int, model: int, rows_div: int = 1
                  ) -> float:
    """``FlopCounterMode``'s count of case ``name``'s step without a mesh,
    its config as the ``data`` x ``model`` mesh set it, at ``rows`` /
    ``rows_div`` rows; ``op_costs.analyze`` of the same step (another
    batch of zeros, the parameters and state it updated) counts the
    same."""
    _, arch, kind, rows, seq, mb = next(
        c for c in run.COUNT_CASES if c[0] == name)
    cfg = configs.get_smoke(arch).with_mesh(model, data)
    model_ = dryrun.meta_model(cfg)
    batch = {k: torch.zeros_like(v) for k, v in model_.input_specs(
        ShapeSpec("count", seq, rows // rows_div, kind)).items()}
    if kind == "train":
        init_opt, step = build_train_step(
            model_, TrainStepConfig(optimizer="adamw", microbatches=mb))
        params = model_.params
        opt = init_opt(params)
        with FlopCounterMode(display=False) as fc:
            step(params, opt, batch)
        cost = op_costs.analyze(step, params, opt, batch)
    else:
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            model_.prefill(batch)
        with torch.no_grad():
            cost = op_costs.analyze(lambda b: model_.prefill(b), batch)
    flops = float(fc.get_total_flops())
    assert cost.flops == cost.flops_global == flops
    assert not cost.collective_count
    return flops


@pytest.mark.parametrize("name", [c[0] for c in run.COUNT_CASES])
def test_global_flops_on_a_mesh_equal_no_mesh(runs, name):
    got = runs["fake"]["count"][f"{name}|2x2"]["cost"]
    assert got["flops_global"] == no_mesh_flops(name, 2, 2)
    assert got["flops"] < got["flops_global"]


@pytest.mark.parametrize("name", [c[0] for c in run.COUNT_CASES])
def test_per_device_flops_on_one_device_equal_no_mesh(runs, name):
    got = runs["fake"]["count"][f"{name}|1x1"]["cost"]
    want = no_mesh_flops(name, 1, 1)
    assert got["flops"] == got["flops_global"] == want


@pytest.mark.parametrize("name", [c[0] for c in run.COUNT_CASES])
def test_per_device_flops_on_pure_data_equal_a_quarter_batch(runs, name):
    got = runs["fake"]["count"][f"{name}|4x1"]["cost"]
    assert got["flops"] == no_mesh_flops(name, 4, 1, rows_div=4)
    assert got["flops_global"] == no_mesh_flops(name, 4, 1)


# ---------------------------------------------------------------- (v) --


def test_prefill_flops_within_one_percent_of_parsed_hlo(runs):
    name, seq, rows = ref.PREFILL_SPEC
    want = runs["reference"]["prefill"]
    got = runs["fake"]["count"]["prefill|2x2"]
    assert (seq, rows) == next((c[4], c[3]) for c in run.COUNT_CASES
                               if c[0] == "prefill")
    print("dry run: port", got["cost"]["collective_count"],
          got["cost"]["collective_bytes"], "| XLA",
          want["collective_counts"], want["collective_bytes"])
    assert abs(got["cost"]["flops"] - want["flops_per_device"]) \
        <= 0.01 * want["flops_per_device"], (got["cost"]["flops"], want)


@pytest.mark.parametrize("name", [c[0] for c in run.COUNT_CASES])
def test_devices_flops_sum_to_the_global_count(runs, name):
    """No product runs whole on every model rank: the four devices of
    (2, 2) together count the step without a mesh, within 1 %."""
    got = runs["fake"]["count"][f"{name}|2x2"]["cost"]
    want = no_mesh_flops(name, 2, 2)
    assert abs(4 * got["flops"] - want) <= 0.01 * want, (got["flops"], want)


# ------------------------------------------------------ the mesh faults --

#: The counted train step's peak estimate while the loss's backward (the
#: gather's, on logits sharded over the vocabulary) built each
#: microbatch's whole logits gradient on every rank.
TRAIN_PEAK_BEFORE = 2198164


def test_train_step_builds_no_whole_vocabulary_tensor(runs):
    """The loss's backward scatters into each rank's own vocabulary
    shard: no local tensor spans the vocabulary, and the peak estimate
    falls by at least 90 % of (a microbatch's whole f32 logits gradient
    less one rank's shard)."""
    _, arch, _, rows, seq, mb = next(
        c for c in run.COUNT_CASES if c[0] == "train")
    vocab = configs.get_smoke(arch).padded_vocab
    got = runs["fake"]["count"]["train|2x2"]
    assert not [s for s in got["shapes"] if len(s) >= 3
                and s[-1] == vocab], got["shapes"]
    whole = rows // mb * seq * vocab * 4
    assert got["peak_bytes"] <= TRAIN_PEAK_BEFORE - 0.9 * (whole - whole // 4)


def test_moe_experts_split_by_width_train_at_one_row_a_rank(runs):
    """Few big experts (TP over d_ff, FSDP over d, as grok-1-314b's on
    the production mesh) at one row a rank a microbatch: the backward's
    views of the expert products' gradients hold."""
    got = runs["fake"]["moe"]
    assert not got["moe_ep"]
    assert got["error"] == ""
    assert got["flops"] > 0


@pytest.mark.parametrize("kind", [s[0] for s in run.HYBRID_STEPS])
def test_hybrid_asks_for_no_shard_to_partial(runs, kind):
    """zamba2-7b's steps leave PyTorch 2.11 no ``Shard -> Partial`` to
    make (a redistribution it lacks)."""
    assert runs["fake"]["shard_to_partial"][kind] == []


# --------------------------------------------------------------- (vi) --


def test_run_cell_record(runs):
    rec = runs["fake"]["cells"]["first"]
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == {"arch", "shape", "mesh", "chips", "kind", "device",
                        "params", "active_params", "status", "memory",
                        "counted", "roofline", "build_s", "trace_s"}
    assert set(rec["memory"]) == {"argument_bytes", "peak_estimate_bytes",
                                  "analytic"}
    assert set(rec["counted"]) == {
        "flops_per_device", "flops_global", "hbm_bytes_per_device",
        "collective_bytes", "collective_counts", "collective_wire_bytes",
        "total_collective_bytes", "all_to_all_as_all_gather"}
    assert set(rec["roofline"]) == {
        "compute_s", "memory_s", "collective_s", "dominant",
        "model_flops_per_device", "useful_flops_ratio",
        "step_time_bound_s", "roofline_fraction"}
    want = _reference_cell(runs, run.CELL[2], run.CELL[0], run.CELL[1])
    assert {k: rec[k] for k in want["record"] if k != "status"} \
        == {k: v for k, v in want["record"].items() if k != "status"}
    assert rec["memory"]["analytic"] == want["analytic"]
    roof = rec["roofline"]
    assert roof["model_flops_per_device"] == want["model_flops"]
    assert roof["compute_s"] == rec["counted"]["flops_per_device"] \
        / dryrun.PEAK_FLOPS
    assert roof["step_time_bound_s"] == max(
        roof["compute_s"], roof["memory_s"], roof["collective_s"])
    assert rec["counted"]["flops_per_device"] > 0
    assert rec["memory"]["peak_estimate_bytes"] \
        >= rec["memory"]["argument_bytes"] > 0


def test_run_cell_cache_and_force(runs):
    cells = runs["fake"]["cells"]
    assert cells["cached"] == {**cells["first"], "sentinel": 1}
    assert "sentinel" not in cells["forced"]
    assert cells["forced"]["status"] == "ok"
    assert cells["forced"]["counted"] == cells["first"]["counted"]
    assert "single__whisper-tiny__decode_32k__cpu.json" \
        in cells["files"]


def test_error_is_recorded_as_data(runs):
    cells = runs["fake"]["cells"]
    rec = cells["error"]
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: build refused"
    assert "build refused" in rec["traceback"]
    assert "single__yi-9b__prefill_32k__cpu.json" in cells["files"]
    assert cells["error_exit"] == 1


def test_full_attention_long_500k_skips(runs):
    rec = runs["fake"]["cells"]["skip"]
    want = _reference_cell(runs, "single", "qwen3-8b", "long_500k")
    assert rec == {**want["record"], "device": "cpu"}


def test_make_mesh_on_a_fake_group(runs):
    got = runs["fake"]["make_mesh"]
    assert (got["device_type"], got["shape"]) == ("cpu", [2, 2])
    assert got["wrong_size"].startswith("ValueError: a (4, 4) mesh needs 16")
    assert got["card"]   # no card here; on one, a card mesh is made


def test_cli_on_one_cell(runs):
    cli = runs["cli"]
    assert cli["code"] == 0, cli["stderr"]
    assert f"[{run.CELL[2]}] {run.CELL[0]} x {run.CELL[1]}: OK" \
        in cli["stdout"]
    assert cli["records"] == [f"{run.CELL[2]}__{run.CELL[0]}__"
                              f"{run.CELL[1]}__cpu.json"]
