"""The port's UCP block planner against the JAX package's planner.

``repro_torch.runtime.cbp_runtime`` copies the reference planner's host
arithmetic and runs the Lookahead greedy through the port's allocator
(the CUDA kernel on the card, its plain version on the CPU).  Knobs must
equal the reference exactly: against the numpy-backend planner in
process (the goldens of ``tests/test_substrate.py``: prime dims, m < 8,
both dtypes, several budgets), and against the JAX-device planner and
``lookahead_allocate_grouped`` run in float64 in a subprocess
(``tests/_torch_jax_ref.py``), including a U = 2048 capacity group (the
reference's default budget).  The card's share is in
``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

pytest.importorskip(
    "jax",
    reason="compares with the JAX reference package, not installed here")

from _torch_jax_ref import PLANNER_GROUPS, PLANNER_SPECS, jax_reference
from test_substrate import PLAN_GOLDENS

from repro.runtime import cbp_runtime as ref
from repro_torch.core import cache_controller as cc
from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.runtime import cbp_runtime as rt

GOLDEN_KEYS = list(PLAN_GOLDENS)


def _port_spec(spec: dict) -> dict:
    """A reference spec in the port's vocabulary (``budget_bytes``)."""
    out = {k: v for k, v in spec.items() if k != "vmem_budget"}
    if "vmem_budget" in spec:
        out["budget_bytes"] = spec["vmem_budget"]
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_reference("planner", tmp_path_factory)


def test_default_budget_is_the_reference_planners():
    assert rt.DEFAULT_BUDGET_BYTES == ref.VMEM_BYTES // 8


@pytest.mark.parametrize("key", GOLDEN_KEYS)
def test_plan_matmul_blocks_equals_reference_numpy_planner(key):
    m, n, k, db, budget = key
    kw_ref = {} if budget is None else {"vmem_budget": budget}
    kw_port = {} if budget is None else {"budget_bytes": budget}
    want = ref.plan_matmul_blocks(m, n, k, dtype_bytes=db,
                                  allocator_backend="numpy", **kw_ref)
    got = rt.plan_matmul_blocks(m, n, k, dtype_bytes=db, device="cpu",
                                **kw_port)
    assert got == want == PLAN_GOLDENS[key]


def test_batched_planner_equals_scalar_planner():
    shapes = [key[:3] for key in GOLDEN_KEYS]
    dbs = [key[3] for key in GOLDEN_KEYS]
    budgets = [key[4] or rt.DEFAULT_BUDGET_BYTES for key in GOLDEN_KEYS]
    got = rt.plan_matmul_blocks_batched(shapes, dtype_bytes=dbs,
                                        budget_bytes=budgets, device="cpu")
    # The scalar planner gives the goldens (the parametrised test above).
    assert got == list(PLAN_GOLDENS.values())
    assert rt.plan_matmul_blocks_batched([], device="cpu") == []


@pytest.mark.parametrize("i", range(len(PLANNER_SPECS)))
def test_plan_kernel_blocks_equals_reference_numpy_planner(i):
    spec = PLANNER_SPECS[i]
    want = ref.plan_kernel_blocks([dict(spec)], allocator_backend="numpy")
    assert rt.plan_kernel_blocks([_port_spec(spec)], device="cpu") == want


def test_plan_kernel_blocks_equals_jax_device_planner(jax_ref):
    got = rt.plan_kernel_blocks([_port_spec(s) for s in PLANNER_SPECS],
                                device="cpu")
    for i, kn in enumerate(got):
        np.testing.assert_array_equal(list(kn.values()),
                                      jax_ref[f"spec{i}_knobs"])


def test_record_specs_plan_the_record_knobs():
    """The four specs of kernel_block_plan_bench plan the knobs of the
    committed results/bench/kernel_blocks.json."""
    got = rt.plan_kernel_blocks([_port_spec(s) for s in PLANNER_SPECS[:4]],
                                device="cpu")
    assert got == [{"block_m": 256, "block_n": 256, "block_k": 256},
                   {"block_q": 256, "block_kv": 256}, {"block_kv": 128},
                   {"chunk": 128}]


def test_grouped_allocation_equals_jax_and_scalar_allocator(jax_ref):
    curves = [jax_ref[f"group{i}_curves"] for i in range(len(PLANNER_GROUPS))]
    units = [U for _B, _n, U, _m, _k in PLANNER_GROUPS]
    mins = [m for _B, _n, _U, m, _k in PLANNER_GROUPS]
    assert 2048 in units
    got = cc.lookahead_allocate_grouped(curves, units, min_units=mins,
                                        device="cpu")
    for i, (c, U, m, alloc) in enumerate(zip(curves, units, mins, got)):
        np.testing.assert_array_equal(alloc, jax_ref[f"group{i}_alloc"])
        np.testing.assert_array_equal(
            alloc, cc.lookahead_allocate(c, U, m, device="cpu"))
        assert alloc.dtype == np.int64 and (alloc.sum(-1) == U).all()


@pytest.mark.parametrize("bad", ["lengths", "empty", "ndim", "width", "mins"])
def test_grouped_allocation_rejects_bad_groups(bad):
    curves = np.zeros((2, 3, 9))
    args = {"lengths": ([curves], [8, 8], 2),
            "empty": ([], [], 2),
            "ndim": ([curves[0]], [8], 2),
            "width": ([curves], [9], 2),
            "mins": ([curves], [8], 3)}[bad]
    with pytest.raises(ValueError):
        cc.lookahead_allocate_grouped(*args, device="cpu")


def test_plan_kernel_blocks_rejects_unknown_kernel():
    with pytest.raises(ValueError, match="unknown kernel"):
        rt.plan_kernel_blocks([{"kernel": "conv"}], device="cpu")


def test_planning_on_the_cpu_launches_no_kernel():
    reset_launch_counts()
    rt.plan_kernel_blocks([_port_spec(s) for s in PLANNER_SPECS[:4]],
                          device="cpu")
    assert all(v == 0 for v in launch_counts().values())
