"""Fig. 5's static search on the card, against the reference's numpy
golden (``tests/data/static_search_golden.json``,
``tools/static_search_golden.py``).

On the card each top-k index equals the golden's or names its *twin* (the
same allocation of the same applications under a permutation of
equal-named positions, found from the workloads and the grid, never from
scores): twins tie in exact arithmetic, in the banked regime too, and the
card's float64 ``exp`` may differ from glibc's in the last bit, which can
turn the golden's rounding-decided choice between them.  The search's own selection
is checked against a stable argsort of the card's scores of the whole
grid, bit for bit.  Weighted speedups are within the reference's device
tolerance of the golden (rtol 1e-5, ``tests/test_static_search.py:64``),
the Pareto case within 1e-12 (l.383-389).

Every test needs an NVIDIA card (``cuda`` marker; skipped without one);
on the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_*.py``.  The file imports neither JAX nor the JAX
package.
"""
import numpy as np
import pytest
import torch

from _static_golden import load, port_run

from repro_torch.core.dispatch import launch_counts, reset_launch_counts
from repro_torch.sim import static_search as P

pytestmark = pytest.mark.cuda

GOLDEN = load()
#: The reference's tolerance for its device backend against numpy.
WS_RTOL = 1e-5
#: The reference's tolerance for the Pareto case on its device backend.
PARETO_RTOL = 1e-12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this file checks the search's "
                    "selection under the card's rounding")


def index_rule(res, want) -> dict:
    """Every slot's index equals the golden's or is its twin; returns the
    twin picks per family."""
    twins = {}
    for fam, w in want["families"].items():
        got, ref = res.topk_index[fam], w["topk_index"]
        twins[fam] = 0
        for wi, (g_row, w_row) in enumerate(zip(got, ref)):
            for g, r in zip(g_row, w_row):
                assert P.is_twin(res.grids[fam], want["workloads"][wi],
                                 int(r), int(g)), (fam, wi, g, r)
                twins[fam] += int(g != r)
        np.testing.assert_allclose(res.topk_ws[fam], w["topk_ws"],
                                   rtol=WS_RTOL, atol=0, err_msg=fam)
    return twins


def family_banks(fam) -> int:
    specs = {**P.FIG5_FAMILIES, **P.registry_families()}
    return specs[fam].bandwidth_banks


@pytest.mark.parametrize("name", ["smoke", "smoke_registry"])
def test_card_index_rule_and_own_order(card, name):
    """The smoke configuration over the Fig. 5 and the registry families
    (the banked ``bank bw`` among them): the index rule against the
    golden, and the top-k equal to the stable descending argsort of the
    card's own scores of each whole grid."""
    args, want = GOLDEN[name]
    reset_launch_counts()
    res = port_run(args, None)
    assert launch_counts()["lookahead_greedy"] == 0
    assert res.backend == "cuda"
    index_rule(res, want)
    for fam in res.family_names:
        scores = P._grid_scores(res.workloads, res.grids[fam],
                                family_banks(fam)).cpu().numpy()
        order = np.argsort(-scores, axis=-1, kind="stable")[:, :args["k"]]
        m = order.shape[1]                 # fewer configs than k: -1 after
        np.testing.assert_array_equal(res.topk_index[fam][:, :m], order,
                                      err_msg=fam)
        np.testing.assert_array_equal(
            res.topk_ws[fam][:, :m],
            np.take_along_axis(scores, order, axis=-1), err_msg=fam)
        assert (res.topk_index[fam][:, m:] == -1).all(), fam


def test_card_pareto_case(card):
    args, want = GOLDEN["pareto"]
    res = port_run(args, "cuda")
    for fam, w in want["families"].items():
        np.testing.assert_array_equal(res.topk_index[fam], w["topk_index"],
                                      err_msg=fam)
        for key in ("topk_ws", "topk_fairness"):
            got = getattr(res, key)[fam]
            np.testing.assert_allclose(got, w[key], rtol=PARETO_RTOL,
                                       atol=0, err_msg=f"{fam} {key}")


def test_card_stacked_bit_identical_to_per_family(card):
    args, _ = GOLDEN["smoke_registry"]
    st = port_run(args, "cuda")
    per = port_run(args, "cuda", stack_families=False)
    for fam in st.family_names:
        np.testing.assert_array_equal(st.topk_ws[fam], per.topk_ws[fam],
                                      err_msg=fam)
        np.testing.assert_array_equal(st.topk_index[fam],
                                      per.topk_index[fam], err_msg=fam)


def test_card_chunked_equals_unchunked(card):
    """Many small chunks select what one chunk selects, bit for bit."""
    args, _ = GOLDEN["smoke"]
    one = port_run(args, "cuda")
    many = port_run(args, "cuda", chunk_elements=4096)
    for fam in one.family_names:
        np.testing.assert_array_equal(one.topk_index[fam],
                                      many.topk_index[fam], err_msg=fam)
        np.testing.assert_array_equal(one.topk_ws[fam], many.topk_ws[fam],
                                      err_msg=fam)


def test_device_none_runs_on_the_card(card):
    res = P.search_static([["lbm", "mcf"], ["gcc", "milc"]], k=2)
    assert res.backend == "cuda"
    assert all(np.isfinite(res.best_ws(f)).all() for f in res.family_names)
