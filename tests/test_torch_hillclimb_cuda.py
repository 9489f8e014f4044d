"""The Fig. 5 seeded climb of ``repro_torch.launch.hillclimb`` on the card
against the same climb on the CPU, in both seed modes: each workload's
climbed allocation equal (or, where the card's search seeds from a twin
index, tied within 1e-9 under the CPU's model), each weighted speedup
within rtol 1e-9.

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_hillclimb_cuda.py``.  The file imports neither JAX nor
the JAX package.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import hillclimb as H

pytestmark = pytest.mark.cuda

N_WORKLOADS, K = 2, 2
RTOL = 1e-9


def _ws_cpu(workload, config) -> float:
    """``config``'s weighted speedup under the port's model on the CPU,
    against the equal-share baseline (prefetch off)."""
    from repro_torch.sim import memsys
    from repro_torch.sim.apps import app_fields, from_numpy, stack
    from repro_torch.sim.runner import equal_share
    from repro_torch.sim.static_search import (FIG5_FAMILIES, StaticOptions,
                                               family_grid)

    n = len(workload)
    grid = family_grid(FIG5_FAMILIES[H.FIG5_FAMILY], n, StaticOptions())
    params = from_numpy(app_fields(stack(workload)), torch.device("cpu"))

    def ipc(c, b, p):
        return memsys.evaluate(
            params, np.asarray(c, dtype=np.float64), np.asarray(b),
            np.asarray(p), total_cache_units=grid.total_cache_units,
            total_bandwidth_gbps=grid.total_bandwidth_gbps, iters=40).ipc

    units, bw = equal_share(n, grid.total_cache_units,
                            grid.total_bandwidth_gbps)
    base = ipc(units, bw, np.zeros(n))
    got = ipc(config["cache_units"], config["bandwidth_gbps"],
              config["prefetch_on"])
    return float(torch.mean(got / base))


@pytest.mark.parametrize("multi", [False, True], ids=["scalar", "multi"])
def test_card_climb_equals_the_cpu(multi):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this file holds the climb's "
                    "scores on the card against the CPU's")
    card = H.climb_rows(N_WORKLOADS, K, multi, None)
    cpu = H.climb_rows(N_WORKLOADS, K, multi, "cpu")
    for g, w in zip(card, cpu):
        assert g["workload"] == w["workload"]
        if g["config"] != w["config"]:
            a, b = (_ws_cpu(g["workload"], g["config"]),
                    _ws_cpu(w["workload"], w["config"]))
            assert abs(a - b) <= RTOL * abs(b), (g, w)
        assert np.isclose(g["refined_ws"], w["refined_ws"], rtol=RTOL,
                          atol=0)
