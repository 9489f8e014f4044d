"""The training-loop binding of the port on the CPU: the fused Fig. 8 knob
schedule (``repro_torch.runtime.plant.run_fused_schedule``), its host
golden (``host_reference_run``: the port's ``CBPCoordinator`` over its
``TrainingPlant``) and the plant model, against the JAX package.

The fused trajectory must equal the reference's golden bit for bit on
all eight fields, for every case of ``tests/test_plant_jax.py`` and both
shapes of ``benchmarks/runtime_bench.py``: against the reference's numpy
``host_reference_run`` run here, against its ``run_fused_schedule`` run
in float64 in a subprocess (``tests/_torch_jax_ref.py``), and against
the committed ``tests/data/plant_golden.json``, which a test regenerates
here so that it cannot go stale.  The port's ``host_reference_run``
sums Algorithm 1's delays with ``torch.sum``, whose order is not numpy's:
its discrete fields must be equal, its floats within
:data:`HOST_RTOL` (measured: at most 5.3e-16 on these cases).
"""
import functools
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from _plant_golden import (
    FIELDS,
    LONG_CASES,
    assert_bit_identical,
    assert_within,
    load,
    plant_model,
    port_kwargs,
)
from _torch_jax_ref import jax_reference

from repro.train import plant_model as ref_model
from repro_torch.core.dispatch import (
    launch_counts,
    record_launches,
    reset_launch_counts,
    uncounted,
)
from repro_torch.core.coordinator import CBPCoordinator
from repro_torch.core.types import CBPParams
from repro_torch.graph import CapturedProgram
from repro_torch.runtime import TrainingPlant, plant
from repro_torch.runtime.plant import (
    FusedTrainingPlant,
    host_reference_run,
    numpy_order_sum,
    run_fused_schedule,
    trajectory_from_history,
)
from repro_torch.train.plant_model import plant_constants

ROOT = Path(__file__).resolve().parents[1]

#: Relative limit of the port's host golden against the reference's: the
#: controllers' float64 tolerance (ROADMAP parity rules).
HOST_RTOL = 1e-12

GOLDEN = load()
CASES = [name for name in GOLDEN if name not in LONG_CASES]


def _tool():
    """``tools/plant_golden.py``, which runs the reference's numpy host
    golden (``reference_run``) and writes the committed file."""
    path = ROOT / "tools" / "plant_golden.py"
    spec = importlib.util.spec_from_file_location("plant_golden", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


TOOL = _tool()


@pytest.fixture(scope="module")
def jax_fused(tmp_path_factory):
    return jax_reference("plant", tmp_path_factory)


@functools.lru_cache(maxsize=None)
def fused_cpu(name):
    args, _ = GOLDEN[name]
    _step_fn, step_model = plant_model(args, "cpu")
    return run_fused_schedule(step_model, **port_kwargs(args), device="cpu")


@pytest.mark.parametrize("name", CASES)
def test_fused_cpu_bit_identical_to_reference_host_golden(name):
    want = TOOL.reference_run(GOLDEN[name][0])
    assert_bit_identical(fused_cpu(name),
                         {f: getattr(want, f) for f in FIELDS}, name)


@pytest.mark.parametrize("name", CASES)
def test_fused_cpu_bit_identical_to_reference_fused_x64(name, jax_fused):
    want = {f: jax_fused[f"{name}|{f}"] for f in FIELDS}
    assert_bit_identical(fused_cpu(name), want, name)


@pytest.mark.parametrize("name", CASES)
def test_fused_cpu_bit_identical_to_committed_golden(name):
    assert_bit_identical(fused_cpu(name), GOLDEN[name][1], name)


def test_committed_golden_is_the_reference_run():
    assert TOOL.PATH.read_text() == TOOL.dumps(TOOL.golden())


@pytest.mark.parametrize("name", CASES)
def test_host_reference_run_within_tolerance(name):
    args, want = GOLDEN[name]
    step_fn, _ = plant_model(args, "cpu")
    got = host_reference_run(step_fn, **port_kwargs(args), device="cpu")
    assert assert_within(got, want, HOST_RTOL, name) <= HOST_RTOL


def test_training_plant_numpy_allocator_matches_device():
    """``TrainingPlant(allocator_backend="numpy")`` (the host golden
    greedy) gives ``host_reference_run``'s trajectory."""
    args, _ = GOLDEN["shape_seed7"]
    step_fn, _ = plant_model(args, "cpu")
    kw = port_kwargs(args)
    dev = host_reference_run(step_fn, **kw, device="cpu")
    tp = TrainingPlant(kw["n_clients"], kw["total_units"],
                       kw["total_bandwidth"], step_fn,
                       allocator_backend="numpy", device="cpu")
    coord = CBPCoordinator(tp, kw["params"])
    host = trajectory_from_history(coord.run(kw["total_ms"]), dev.kinds)
    assert_bit_identical(host, {f: getattr(dev, f) for f in FIELDS})


def test_seed0_golden_literals():
    """The reference test's pinned seed-0 trajectory
    (``tests/test_plant_jax.py::test_fused_plant_golden_trajectory_seed0``)
    through ``FusedTrainingPlant``."""
    args, _ = GOLDEN["base"]
    _step_fn, step_model = plant_model(args, "cpu")
    res = FusedTrainingPlant(4, 48, 64.0, step_model, device="cpu").run(
        60.0, params=CBPParams(**args["params"]))
    assert_bit_identical(res, GOLDEN["base"][1])
    assert len(res.kinds) == 18
    assert res.kinds.tolist() == [0, 1, 2] * 6
    assert res.duration_ms.sum() == 60.0
    np.testing.assert_array_equal(res.cache_units[-1], [10, 16, 14, 8])
    np.testing.assert_array_equal(res.prefetch_on[-1],
                                  [True, True, False, False])
    np.testing.assert_allclose(
        res.bandwidth[-1],
        [12.040298212087718, 19.93764745844568,
         17.58097142792976, 14.44108290153684], rtol=0, atol=0)
    np.testing.assert_allclose(
        res.mean_ipc(),
        [2.455269686809507, 2.3384549025142496,
         1.9288628566770705, 1.4381098901010647], rtol=0, atol=0)


@pytest.mark.parametrize("seed,n,units", [(0, 4, 48), (3, 6, 64),
                                          (7, 12, 96), (11, 5, 40)])
def test_plant_constants_equal_the_reference(seed, n, units):
    step_fn, _ = ref_model.make_stream_plant_model(n, units, 64.0, seed=seed)
    want = inspect.getclosurevars(step_fn).nonlocals["c"]
    got = plant_constants(n, units, seed)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k,
                                      strict=True)


def test_step_fn_equals_the_reference_step_fn():
    from repro.runtime.cbp_runtime import StreamKnobs as RefKnobs
    from repro_torch.runtime.cbp_runtime import StreamKnobs

    rng = np.random.default_rng(5)
    n, units, bw = 7, 56, 90.0
    ref_fn, _ = ref_model.make_stream_plant_model(n, units, bw, seed=9)
    fn, _ = plant_model({"n_clients": n, "total_units": units,
                         "total_bandwidth": bw, "seed": 9}, "cpu")
    for _ in range(3):
        u = rng.integers(0, units, n)
        b = rng.uniform(0.5, 20.0, n)
        pf = rng.integers(0, 2, n).astype(bool)
        want = ref_fn(1.0, RefKnobs(u, b, pf))
        got = fn(1.0, StreamKnobs(torch.as_tensor(u), torch.as_tensor(b),
                                  torch.as_tensor(pf)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w, strict=True)


@pytest.mark.parametrize("lo,hi", [(1, 8), (8, 129), (129, 301)])
def test_numpy_order_sum_equals_numpy(lo, hi):
    """Sequential (m < 8), eight lanes (m <= 128), recursive halving."""
    rng = np.random.default_rng(lo)
    for m in range(lo, hi):
        vec = rng.standard_normal(m) * 10.0 ** rng.integers(-8, 8, m)
        got = numpy_order_sum(torch.as_tensor(vec))
        assert got.shape == (1,)
        assert got.item() == np.add.reduce(vec), m


def test_infeasible_floors_raise_before_any_device_work():
    """ValueError before the device is resolved: ``device=None`` means the
    card, which raises RuntimeError here."""
    _, step_model = plant_model(GOLDEN["base"][0], "cpu")
    with pytest.raises(ValueError, match="exceeds total bandwidth"):
        run_fused_schedule(step_model, n_clients=4, total_units=48,
                           total_bandwidth=4.0, total_ms=10.0,
                           params=CBPParams(min_bandwidth_allocation=2.0))
    with pytest.raises(ValueError, match="min_ways"):
        run_fused_schedule(step_model, n_clients=4, total_units=4,
                           total_bandwidth=64.0, total_ms=10.0,
                           params=CBPParams(min_ways=4))


def test_cpu_runs_launch_nothing_and_share_a_program_per_schedule():
    """On the CPU the body runs eagerly: no kernel launch, no graph
    replay.  Params that share a schedule share one program (its static
    inputs refilled per run) and each run equals its own golden."""
    args, want = GOLDEN["base"]
    args2, want2 = GOLDEN["base_params2"]
    assert {k: v for k, v in args.items() if k != "params"} == \
        {k: v for k, v in args2.items() if k != "params"}
    _step_fn, step_model = plant_model(args, "cpu")
    reset_launch_counts()
    programs = plant._schedule_program.cache_info().currsize
    for a, w in ((args, want), (args2, want2), (args, want)):
        res = run_fused_schedule(step_model, **port_kwargs(a), device="cpu")
        assert_bit_identical(res, w)
    assert plant._schedule_program.cache_info().currsize == programs + 1
    assert all(v == 0 for v in launch_counts().values()), launch_counts()


def test_uncounted_restores_counters_and_returns_the_gain():
    from repro_torch.kernels.lookahead_greedy import LAUNCHES

    reset_launch_counts()
    LAUNCHES.record()
    with uncounted() as gained:
        LAUNCHES.record(3)
    assert gained == {"lookahead_greedy": 3}
    assert launch_counts()["lookahead_greedy"] == 1
    record_launches(gained)
    assert launch_counts()["lookahead_greedy"] == 4
    reset_launch_counts()


def test_captured_program_needs_a_cuda_device():
    from repro_torch.core.dispatch import SCHEDULE_GRAPH_REPLAYS

    with pytest.raises(ValueError, match="cuda"):
        CapturedProgram(lambda: torch.zeros(1), torch.device("cpu"),
                        SCHEDULE_GRAPH_REPLAYS)
