"""The port's interval model against ``memsys_jax`` (float64, subprocess)
and the numpy golden ``repro.sim.memsys``.

Tolerances: rtol 1e-9 against ``memsys_jax`` — both solve the same
float64 fixed point with the same op order, and differ only in the last
bits of ``exp`` and of the sums; 1e-5 against the numpy golden, the
reference's own model tolerance.

One exception, stated rather than hidden: in the banked regime at
saturation the damped iteration amplifies rounding about tenfold every
five iterations, so after 60 iterations ``memsys_jax`` itself lies up to
3.6e-6 from the numpy golden on two rows of these inputs (the port lies
5e-15 from it).  Where the two references disagree beyond 1e-9, the port
is held to the golden instead: no farther from it than ``memsys_jax`` is.
"""
import numpy as np
import pytest
import torch
from _torch_jax_ref import (
    EVAL_FLAGS,
    jax_reference,
    memsys_inputs,
    rowflag_inputs,
)

from repro.sim import memsys as golden
from repro_torch.sim import memsys
from repro_torch.sim.apps import app_fields, from_numpy

FIELDS = ("ipc", "queuing_delay_ns", "traffic_gbps", "mpki",
          "exposed_mpki", "occupancy_units")


def assert_matches_references(got, jax, golden_value, what):
    """rtol 1e-9 to ``memsys_jax`` where it agrees with the numpy golden
    to 1e-9; elsewhere no farther from the golden than ``memsys_jax``."""
    scale = np.maximum(np.abs(golden_value), 1e-12)
    ref_gap = np.abs(jax - golden_value) / scale
    resolved = ref_gap <= 1e-9
    assert resolved.any(), f"{what}: the references disagree everywhere"
    np.testing.assert_allclose(got[resolved], jax[resolved], rtol=1e-9,
                               atol=1e-12, err_msg=what)
    port_gap = np.abs(got - golden_value) / scale
    assert np.all(port_gap[~resolved] <= ref_gap[~resolved]), what
    np.testing.assert_allclose(got, golden_value, rtol=1e-5, atol=1e-9,
                               err_msg=what)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_reference("memsys", tmp_path_factory)


@pytest.fixture(scope="module")
def inputs():
    return memsys_inputs(np.random.default_rng(3))


@pytest.mark.parametrize("cp,bp,banks", EVAL_FLAGS)
def test_evaluate_matches_jax_and_numpy(jax_ref, inputs, cp, bp, banks):
    apps, units, bw, pf = inputs
    params = from_numpy(app_fields(apps), torch.device("cpu"))
    ss = memsys.evaluate(params, units, bw, pf, cache_partitioned=cp,
                         bandwidth_partitioned=bp, bandwidth_banks=banks)
    want = golden.evaluate(apps, units, bw, pf, cache_partitioned=cp,
                           bandwidth_partitioned=bp, bandwidth_banks=banks)
    for f in FIELDS:
        assert_matches_references(
            getattr(ss, f).numpy(),
            jax_ref[f"eval_{int(cp)}{int(bp)}{banks}_{f}"],
            getattr(want, f), f)


@pytest.mark.parametrize("max_banks", [1, 4])
def test_evaluate_rowflags_mixed_rows(jax_ref, inputs, max_banks):
    apps, units, bw, pf = inputs
    tile, u6, b6, p6, cpart, bpart, banks = rowflag_inputs(
        apps, units, bw, pf)
    t = torch.as_tensor
    ipc, q_ns, *_ = memsys._evaluate_rowflags(
        {k: t(v) for k, v in tile.items()}, t(u6), t(b6), t(p6), 256.0,
        64.0, 0.0, t(cpart), t(bpart), iters=60,
        bandwidth_banks=t(banks) if max_banks > 1 else None,
        max_banks=max_banks)
    # The golden per row: the numpy model with that row's static flags
    # (banked only where the row is partitioned and max_banks admits it).
    want = [golden.evaluate(
        golden.AppArrays(**{k: v[r] for k, v in tile.items()}),
        u6[r], b6[r], p6[r], cache_partitioned=bool(cpart[r, 0]),
        bandwidth_partitioned=bool(bpart[r, 0]),
        bandwidth_banks=int(banks[r, 0]) if max_banks > 1 else 1)
        for r in range(6)]
    assert_matches_references(
        ipc.numpy(), jax_ref[f"rowflags_{max_banks}_ipc"],
        np.stack([w.ipc for w in want]), "ipc")
    assert_matches_references(
        q_ns.numpy(), jax_ref[f"rowflags_{max_banks}_q"],
        np.stack([w.queuing_delay_ns for w in want]), "queuing delay")


def test_utility_curves_match_jax_and_numpy(jax_ref, inputs):
    apps, _units, _bw, pf = inputs
    params = from_numpy(app_fields(apps), torch.device("cpu"))
    ipc = jax_ref["curves_ipc"]
    got = memsys.utility_curves(params, pf, ipc, 256, duration_ms=0.5)
    assert got.shape == (2, 16, 257) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), jax_ref["curves"], rtol=1e-9,
                               atol=1e-9)
    for m in range(2):
        one = golden.AppArrays(**{f: getattr(apps, f)[m]
                                  for f in app_fields(apps)})
        want = golden.utility_curves(one, pf[m], ipc[m], 256,
                                     duration_ms=0.5)
        np.testing.assert_allclose(got[m].numpy(), want, rtol=1e-5,
                                   atol=1e-9)


def test_mpki_curve_matches_numpy_golden(inputs):
    apps = inputs[0]
    params = from_numpy(app_fields(apps), torch.device("cpu"))
    u = np.linspace(0.0, 300.0, 16)
    got = memsys.mpki_curve(params, torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), golden.mpki_curve(apps, u),
                               rtol=1e-12)


def test_bank_affinity_matches_numpy_golden():
    got = memsys._bank_affinity(16, 4, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), golden.bank_affinity(16, 4),
                               rtol=1e-15)


def test_constants_equal_numpy_golden():
    for name in ("FREQ_GHZ", "DRAM_LAT_NS", "LINE_BYTES", "Q_SCALE_NS",
                 "IF_SKEW", "PF_QUEUE_WEIGHT", "RHO_MAX",
                 "FIXED_POINT_ITERS", "DAMPING", "BANK_SKEW",
                 "DEFAULT_BANDWIDTH_BANKS"):
        assert getattr(memsys, name) == getattr(golden, name), name
