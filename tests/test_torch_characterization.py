"""The port's single-application characterization (paper §2.1, Figs. 2-4)
against the JAX package's numpy reference, computed in-process (it
imports no JAX): every value within 1e-9 relative, the Fig. 2 counts,
observations 1-5 and the named behaviours of
``tests/test_sim_characterization.py`` on the port's own outputs."""
import numpy as np
import pytest

from repro.sim import characterization as ref
from repro_torch.sim import characterization as ch
from repro_torch.sim.apps import APP_NAMES, EXPECTED_CLASS_COUNTS

RTOL = 1e-9


@pytest.fixture(scope="module")
def table():
    return ch.sensitivity_table(device="cpu")


@pytest.fixture(scope="module")
def classes(table):
    return {app: ch.classify(row) for app, row in table.items()}


@pytest.fixture(scope="module")
def fig4():
    return ch.leslie3d_interactions(device="cpu")


def test_sensitivity_table_matches_reference(table):
    want = ref.sensitivity_table()
    assert list(table) == list(want) == APP_NAMES
    for app, row in table.items():
        assert list(row) == list(want[app])
        for key, value in row.items():
            np.testing.assert_allclose(value, want[app][key], rtol=RTOL,
                                       atol=1e-15, err_msg=(app, key))


def test_classes_match_reference(classes):
    assert classes == ref.classify_all()
    assert ch.classify_all(device="cpu") == classes


def test_fig2_classification_counts(classes):
    """Paper Fig. 2 caption: 6 CS-BS-PS, 8 CS-BS, 6 BS-PS, 3 CS, 3 BS, 3 I."""
    counts = {}
    for cls in classes.values():
        counts[cls] = counts.get(cls, 0) + 1
    assert counts == EXPECTED_CLASS_COUNTS


def test_obs1_sensitivity_fractions(classes):
    n = len(classes)
    assert sum(1 for c in classes.values() if c != "I") / n >= 0.85
    assert sum(1 for c in classes.values() if "-" in c) / n >= 0.65


def test_named_behaviours(classes, table):
    assert classes["lbm"] == "BS-PS"
    assert classes["xalancbmk"] == "CS-BS"
    assert classes["leslie3d"] == "CS-BS-PS"
    assert classes["libquantum"] == "BS-PS"
    assert classes["povray"] == "I"
    assert table["xalancbmk"]["P-B"] < -0.05


def test_low_allocation_sensitivity_exceeds_high(table):
    thr = ch.SENSITIVITY_THRESHOLD
    for lo, hi in (("C-L", "C-H"), ("B-L", "B-H")):
        assert (sum(1 for r in table.values() if abs(r[lo]) >= thr)
                >= sum(1 for r in table.values() if abs(r[hi]) >= thr))


@pytest.mark.parametrize("app", ["hmmer", "gcc", "leslie3d"])
def test_prefetch_vs_allocation_matches_reference(app):
    got = ch.prefetch_vs_allocation(app, device="cpu")
    want = ref.prefetch_vs_allocation(app)
    assert list(got) == list(want)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=1e-15)


def test_obs2_prefetch_sensitivity_depends_on_allocation():
    hmmer = ch.prefetch_vs_allocation("hmmer", device="cpu")
    assert hmmer["P-L"] >= 0.10 and hmmer["P-B"] < 0.10
    gcc = ch.prefetch_vs_allocation("gcc", device="cpu")
    assert gcc["P-H"] > 0.0 and gcc["P-H"] >= gcc["P-L"]


def test_leslie3d_interactions_match_reference(fig4):
    want = ref.leslie3d_interactions()
    assert fig4.keys() == want.keys()
    for fig, series in fig4.items():
        assert series.keys() == want[fig].keys()
        for key, values in series.items():
            np.testing.assert_allclose(values, want[fig][key], rtol=RTOL,
                                       err_msg=(fig, key))


def test_obs3_to_obs5(fig4):
    a = fig4["fig4a"]
    assert a["on"][-1] / a["off"][-1] > a["on"][0] / a["off"][0]      # obs3
    small_pf = ch._ipc("leslie3d", 4, ch.BASE[1], True, device="cpu")
    base_nopf = ch._ipc("leslie3d", 16, ch.BASE[1], False, device="cpu")
    assert small_pf >= 0.95 * base_nopf                               # obs4
    d = fig4["fig4d"]["gain"]
    assert d[0] > d[-1] and d[0] >= 0.10                              # obs5


@pytest.mark.parametrize("app,resource", [("omnetpp", "cache"),
                                          ("lbm", "bandwidth")])
def test_monotonicity(app, resource):
    """More cache / bandwidth never hurts (one app, pf off), and one
    batched evaluation equals point-by-point ones to 1e-9."""
    if resource == "cache":
        pts = [(app, u, 4.0, False) for u in (4, 8, 16, 32, 64, 128)]
    else:
        pts = [(app, 16, b, False) for b in (1.0, 2.0, 4.0, 8.0, 16.0)]
    ipcs = ch._ipcs(pts, device="cpu")
    assert all(b >= a - 1e-9 for a, b in zip(ipcs, ipcs[1:]))
    np.testing.assert_allclose(
        ipcs, [ref._ipc(*p[:3], pf=p[3]) for p in pts], rtol=RTOL)
