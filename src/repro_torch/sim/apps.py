"""SPEC-CPU2006-like application profiles (copy of :mod:`repro.sim.apps`).

The port keeps its own copy of the 29-profile table, :class:`AppArrays`
and :func:`stack_mixes` (``tests/test_torch_sweep.py`` holds the copy
equal to the reference), plus :func:`from_numpy`, which carries the
profile fields onto a device as float64 tensors — what weights are to a
model, the profile parameters are to this simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.device import F64

# Allocation quanta: one unit = 32 kB (the paper's enforcement granularity).
UNIT_KB = 32
TOTAL_UNITS_8MB = 256          # 16 tiles x 512 kB
BASELINE_UNITS = 16            # 512 kB
MIN_UNITS = 4                  # 128 kB = paper's min_ways floor
TOTAL_BW_GBPS = 64.0           # 4 MCUs x 16 GB/s (paper Table 1)
BASELINE_BW_GBPS = 4.0         # per-app baseline (paper §2.1)


@dataclasses.dataclass(frozen=True)
class AppProfile:
    name: str
    abbrev: str
    cpi_base: float      # core-bound CPI (no LLC-miss stalls)
    apki: float          # LLC accesses per kilo-instruction
    mpki_min_alloc: float  # MPKI at 4 units (128 kB)
    mpki_floor: float    # asymptotic MPKI with unbounded cache
    ws_units: float      # miss-curve decay constant (32 kB units)
    mlp: float           # memory-level parallelism (penalty divisor)
    wb_frac: float       # writeback traffic as fraction of misses
    pf_cov: float        # prefetch coverage (fraction of misses prefetched)
    pf_acc: float        # prefetch accuracy (useful / issued)
    pf_hide: float       # latency fraction hidden for covered misses
    pf_pollution: float  # effective cache units lost to useless prefetches


# name, abbr, cpi,  apki, mpk4, mpkF,  ws,  mlp,  wb,  cov,  acc, hide, pol
_TABLE = [
    # --- CS-BS-PS (6): sensitive to all three -------------------------------
    ("mcf",        "mc",  0.90, 65.0, 48.0, 10.0,  60.0, 4.0, 0.30, 0.48, 0.75, 0.85, 1.0),
    ("leslie3d",   "le",  0.70, 28.0, 16.0,  2.5,  40.0, 3.5, 0.40, 0.55, 0.75, 0.85, 1.0),
    ("soplex",     "so",  0.80, 30.0, 20.0,  4.0,  45.0, 3.5, 0.30, 0.35, 0.70, 0.80, 1.0),
    ("sphinx3",    "sp",  0.70, 25.0, 14.0,  1.5,  35.0, 3.0, 0.20, 0.45, 0.75, 0.85, 1.0),
    ("gcc",        "gc",  0.80, 22.0, 13.0,  1.0,  80.0, 3.0, 0.40, 0.50, 0.60, 0.80, 3.0),
    ("dealII",     "de",  0.60, 18.0, 11.0,  1.2,  30.0, 2.5, 0.20, 0.40, 0.70, 0.80, 1.0),
    # --- CS-BS (8): cache + bandwidth ---------------------------------------
    ("xalancbmk",  "xa",  0.70, 24.0, 18.0,  1.5,  35.0, 1.7, 0.20, 0.25, 0.25, 0.50, 6.0),
    ("omnetpp",    "om",  0.80, 26.0, 17.0,  2.5,  50.0, 2.5, 0.30, 0.15, 0.40, 0.50, 2.0),
    ("bzip2",      "bz",  0.70, 14.0,  9.0,  1.5,  30.0, 1.5, 0.40, 0.20, 0.50, 0.60, 1.0),
    ("gobmk",      "go",  0.70, 10.0,  6.5,  0.8,  25.0, 1.4, 0.20, 0.10, 0.50, 0.50, 1.0),
    ("perlbench",  "pe",  0.60, 12.0,  8.0,  0.6,  28.0, 1.5, 0.20, 0.15, 0.50, 0.50, 1.0),
    ("calculix",   "ca",  0.55,  9.0,  6.0,  0.5,  26.0, 1.6, 0.20, 0.15, 0.60, 0.60, 1.0),
    ("hmmer",      "hm",  0.50,  8.0,  6.0,  0.3,   9.0, 1.3, 0.35, 0.33, 0.90, 0.50, 0.0),
    ("astar",      "as",  0.80, 16.0, 10.0,  1.8,  38.0, 1.3, 0.20, 0.10, 0.40, 0.50, 1.0),
    # --- BS-PS (6): streaming — flat miss curves, prefetch-friendly ---------
    ("lbm",        "lb",  0.60, 42.0, 40.0, 36.0, 500.0, 6.0, 0.80, 0.70, 0.85, 0.90, 0.0),
    ("libquantum", "li",  0.50, 35.0, 33.0, 30.0, 500.0, 5.0, 0.10, 0.80, 0.90, 0.90, 0.0),
    ("milc",       "mi",  0.60, 30.0, 28.0, 25.0, 400.0, 5.0, 0.50, 0.50, 0.80, 0.85, 0.0),
    ("bwaves",     "bw",  0.55, 32.0, 30.0, 27.0, 400.0, 5.5, 0.40, 0.60, 0.85, 0.90, 0.0),
    ("zeusmp",     "ze",  0.60, 24.0, 22.0, 19.0, 300.0, 4.5, 0.40, 0.50, 0.80, 0.85, 0.0),
    ("GemsFDTD",   "Ge",  0.65, 28.0, 26.0, 22.0, 350.0, 5.0, 0.50, 0.55, 0.92, 0.90, 0.0),
    # --- CS (3): cache only — low traffic -----------------------------------
    ("h264ref",    "h2",  0.50,  6.0,  3.0,  0.3,  12.0, 1.2, 0.10, 0.15, 0.60, 0.60, 0.0),
    ("tonto",      "to",  0.55,  6.0,  3.2,  0.35, 13.0, 1.5, 0.05, 0.10, 0.50, 0.50, 0.0),
    ("gromacs",    "gr",  0.50,  5.5,  2.8,  0.3,  12.0, 1.2, 0.20, 0.10, 0.50, 0.50, 0.0),
    # --- BS (3): bandwidth only — flat curves, prefetch-unfriendly ----------
    ("cactusADM",  "cac", 0.80, 20.0, 18.0, 15.5, 300.0, 4.0, 0.40, 0.20, 0.50, 0.55, 0.0),
    ("wrf",        "wr",  0.70, 16.0, 14.0, 12.0, 250.0, 4.0, 0.30, 0.18, 0.55, 0.60, 0.0),
    ("sjeng",      "sj",  0.70, 12.0, 11.0,  9.5, 250.0, 3.5, 0.20, 0.10, 0.40, 0.50, 0.0),
    # --- I (3): insensitive — compute bound ---------------------------------
    ("povray",     "po",  0.45,  2.0,  0.30, 0.10,  6.0, 2.0, 0.10, 0.10, 0.50, 0.50, 0.0),
    ("gamess",     "ga",  0.40,  1.5,  0.25, 0.08,  6.0, 2.0, 0.10, 0.10, 0.50, 0.50, 0.0),
    ("namd",       "na",  0.50,  2.5,  0.40, 0.12,  7.0, 2.0, 0.15, 0.15, 0.60, 0.60, 0.0),
]

PROFILES: Dict[str, AppProfile] = {
    row[0]: AppProfile(*row) for row in _TABLE
}
ABBREV: Dict[str, str] = {p.abbrev: p.name for p in PROFILES.values()}
APP_NAMES: List[str] = list(PROFILES.keys())

# Expected Fig. 2 classification (paper caption): used as the calibration
# target; tests assert the model reproduces these counts exactly.
EXPECTED_CLASS_COUNTS = {
    "CS-BS-PS": 6, "CS-BS": 8, "BS-PS": 6, "CS": 3, "BS": 3, "I": 3,
}


@dataclasses.dataclass
class AppArrays:
    """Struct-of-arrays view over a list of profiles (model input)."""

    cpi_base: np.ndarray
    apki: np.ndarray
    mpki_min_alloc: np.ndarray
    mpki_floor: np.ndarray
    ws_units: np.ndarray
    mlp: np.ndarray
    wb_frac: np.ndarray
    pf_cov: np.ndarray
    pf_acc: np.ndarray
    pf_hide: np.ndarray
    pf_pollution: np.ndarray
    names: List[str] = dataclasses.field(default_factory=list)

    @property
    def n(self) -> int:
        """Apps per workload (last axis — fields may carry a mix batch)."""
        return int(np.asarray(self.cpi_base).shape[-1])


#: Numeric model-parameter fields, the single source of truth for the
#: interval model and the stacking helpers.
MODEL_FIELDS = tuple(
    f.name for f in dataclasses.fields(AppArrays) if f.name != "names")


def stack(apps: Sequence[str]) -> AppArrays:
    """Build model-input arrays for a workload (list of app names)."""
    ps = [PROFILES[a] for a in apps]
    arrays = {
        attr: np.array([getattr(p, attr) for p in ps], dtype=np.float64)
        for attr in MODEL_FIELDS
    }
    return AppArrays(names=[p.name for p in ps], **arrays)


def stack_mixes(mixes: Sequence[Sequence[str]]) -> AppArrays:
    """Struct-of-arrays over a batch of equal-size mixes: fields are (M, n).

    The leading mix axis broadcasts straight through the interval model
    (:mod:`repro_torch.sim.memsys`), which is how the sweep evaluates every
    mix at once.
    """
    stacks = [stack(list(m)) for m in mixes]
    sizes = {s.n for s in stacks}
    if len(sizes) != 1:
        raise ValueError(f"mixes must be equal-size, got sizes {sorted(sizes)}")
    arrays = {
        attr: np.stack([getattr(s, attr) for s in stacks])
        for attr in MODEL_FIELDS
    }
    return AppArrays(names=[s.names for s in stacks], **arrays)


def from_numpy(fields: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Model-parameter fields as float64 tensors on ``device``.

    ``fields`` maps every name of :data:`MODEL_FIELDS` to an array of one
    common shape (``(n,)`` for one mix, ``(M, n)`` for a stack) — the
    fields of this module's :class:`AppArrays` or of the JAX package's.
    Extra keys (``names``) are ignored; a missing field or a shape
    mismatch raises.
    """
    missing = [f for f in MODEL_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing model fields {missing}")
    arrays = {f: np.asarray(fields[f], dtype=np.float64)
              for f in MODEL_FIELDS}
    shapes = {a.shape for a in arrays.values()}
    if len(shapes) != 1:
        raise ValueError(f"model fields differ in shape: {sorted(shapes)}")
    return {f: torch.as_tensor(a, dtype=F64, device=device)
            for f, a in arrays.items()}


def app_fields(apps: AppArrays) -> Dict[str, np.ndarray]:
    """The numeric fields of ``apps`` as a dict (input of :func:`from_numpy`)."""
    return {f: getattr(apps, f) for f in MODEL_FIELDS}
