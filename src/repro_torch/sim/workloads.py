"""Workload mixes: paper Table 2, the random Table-3 sweep mixes and the
random Fig. 5 workloads (copy of the parts of :mod:`repro.sim.workloads`
the sweep and the static search use).

Given the same seed, :func:`random_mixes` and :func:`random_workloads`
draw exactly what the reference draws (``tests/test_torch_sweep.py``,
``tests/test_torch_static_search.py``): the draw order of the generator
is part of the reproduction.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.sim.apps import ABBREV, APP_NAMES

# Paper Table 2, "Benchmarks" column, verbatim abbreviation strings.
_TABLE2 = {
    "w1":  "xa,gr,li(2),h2,ze,to,so,lb,pe,ca,mi,sp,bw,go,ga",
    "w2":  "lb,to,pe,go,gc,mi,li(2),na,h2,cac,ze(2),ca,so,as",
    "w3":  "bw(2),po(2),sj(2),sp(2),na(2),ze,Ge,cac,li,mi,wr",
    "w4":  "po,bw(2),h2,sj,li(2),gr,na,mi(2),as,Ge,ga,wr,lb",
    "w5":  "de,om(2),go(2),hm,xa,le,bz(2),gc,so,mc,pe,ca(2)",
    "w6":  "sp,bw(2),h2,om,li,gr,go,mi(2),as,hm,ga,le,lb,ca",
    "w7":  "po(2),to,sj,h2(2),na,lb(2),ze(2),gr,Ge,as,wr,ga",
    "w8":  "de,bw(3),xa,mi(3),om,li(2),bz,go,so,hm,pe",
    "w9":  "gc,po,to,hm,sj,h2,bz,ze,gr,so,Ge,as,pe,wr,ga,cac",
    "w10": "sj,bw(2),de,na,li(2),om,ze,mi(2),xa,Ge,bz,wr,gc",
    "w11": "po,om,sj,go,na(2),le,ze,xa,Ge,bz,wr,ca,sj,sp,gc",
    "w12": "de,to,go,h2(2),hm,gr,xa,as(2),bz,ga,gc,lb,so,ca",
    "w13": "to,po,h2,sj,gr,na,as,ze,ga,Ge,lb(2),li,to,mi,wr",
    "w14": "de,bw,go,po,hm,na,xa,ze,so,Ge,mc,li,pe,mi,ca,wr",
}


def _parse(spec: str) -> List[str]:
    apps: List[str] = []
    for tok in spec.split(","):
        tok = tok.strip()
        if "(" in tok:
            ab, count = tok[:-1].split("(")
            apps.extend([ABBREV[ab]] * int(count))
        else:
            apps.append(ABBREV[tok])
    return apps


WORKLOADS: Dict[str, List[str]] = {k: _parse(v) for k, v in _TABLE2.items()}

for _k, _apps in WORKLOADS.items():
    assert len(_apps) == 16, (_k, len(_apps))


def random_workloads(n_workloads: int, apps_per_workload: int = 4,
                     seed: int = 0) -> List[List[str]]:
    """Randomly generated workloads (paper §2.3: 640 x 4 apps)."""
    rng = np.random.default_rng(seed)
    return [
        [APP_NAMES[i] for i in rng.integers(0, len(APP_NAMES),
                                            size=apps_per_workload)]
        for _ in range(n_workloads)
    ]


# Sensitivity-class buckets (paper Fig. 2 / the _TABLE blocks in apps.py),
# used to draw Table-2-like mixes that always exercise all three resources.
_CLASS_BUCKETS = {
    "CS-BS-PS": ["mcf", "leslie3d", "soplex", "sphinx3", "gcc", "dealII"],
    "CS-BS": ["xalancbmk", "omnetpp", "bzip2", "gobmk", "perlbench",
              "calculix", "hmmer", "astar"],
    "BS-PS": ["lbm", "libquantum", "milc", "bwaves", "zeusmp", "GemsFDTD"],
    "CS": ["h264ref", "tonto", "gromacs"],
    "BS": ["cactusADM", "wrf", "sjeng"],
    "I": ["povray", "gamess", "namd"],
}


def random_mixes(n_mixes: int, apps_per_mix: int = 16, seed: int = 0,
                 balanced: bool = True) -> List[List[str]]:
    """Random 16-app mixes for the Table-3 sweep (:mod:`repro_torch.sim.sweep`).

    With ``balanced=True`` (default) each mix draws at least one application
    from every sensitivity class before filling uniformly, mirroring the
    composition of the paper's Table 2 mixes — every mix then has cache-,
    bandwidth- and prefetch-sensitive clients for the managers to trade off.
    Uniform draws (``balanced=False``) reproduce the §2.3 potential-study
    style instead.
    """
    if balanced and apps_per_mix < len(_CLASS_BUCKETS):
        raise ValueError(
            f"balanced mixes need >= {len(_CLASS_BUCKETS)} apps per mix")
    rng = np.random.default_rng(seed)
    mixes: List[List[str]] = []
    for _ in range(n_mixes):
        apps: List[str] = []
        if balanced:
            for bucket in _CLASS_BUCKETS.values():
                apps.append(bucket[int(rng.integers(0, len(bucket)))])
        fill = apps_per_mix - len(apps)
        apps.extend(APP_NAMES[i]
                    for i in rng.integers(0, len(APP_NAMES), size=fill))
        rng.shuffle(apps)
        mixes.append(apps)
    return mixes
