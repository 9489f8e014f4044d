"""Workload mixes: paper Table 2, the random Table-3 sweep mixes, the
random Fig. 5 workloads and the streaming scenario service (copy of
:mod:`repro.sim.workloads`).

Given the same seed, :func:`random_mixes` and :func:`random_workloads`
draw exactly what the reference draws (``tests/test_torch_sweep.py``,
``tests/test_torch_static_search.py``): the draw order of the generator
is part of the reproduction.

The streaming sweep (:mod:`repro_torch.sim.stream_sweep`) takes its mixes
chunk by chunk: :func:`mix_index_chunk` and :func:`scenario_chunk` are
pure functions of ``(seed, chunk_index)``, so a checkpoint stores only the
cursor.  Every chunk equals the reference's array for array
(``tests/test_torch_stream_parts.py``): changing the draw order here
would make every saved checkpoint of the reference's streams stale.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.sim.apps import ABBREV, APP_NAMES, MODEL_FIELDS, PROFILES

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


# --------------------------------------------------------------------- #
# Chunk-wise mix generation (the 10^5-10^6 streaming scale)
# --------------------------------------------------------------------- #

#: (n_apps, len(MODEL_FIELDS)) per-application parameter matrix, the one
#: fancy-index source of :func:`params_from_indices`.
_PARAM_MATRIX = np.array(
    [[getattr(PROFILES[name], field) for field in MODEL_FIELDS]
     for name in APP_NAMES], dtype=np.float64)

#: Class-bucket membership as index arrays (same order as _CLASS_BUCKETS).
_BUCKET_INDICES = [
    np.array([APP_NAMES.index(a) for a in bucket], dtype=np.int32)
    for bucket in _CLASS_BUCKETS.values()
]

#: Cache- and bandwidth-sensitive app index sets for the diurnal bias
#: (apps can be in both; the bias re-weights, never excludes).
_CACHE_SENSITIVE = np.array(
    sorted({APP_NAMES.index(a)
            for key, bucket in _CLASS_BUCKETS.items() if "CS" in key
            for a in bucket}), dtype=np.int64)
_BW_SENSITIVE = np.array(
    sorted({APP_NAMES.index(a)
            for key, bucket in _CLASS_BUCKETS.items() if "BS" in key
            for a in bucket}), dtype=np.int64)


def _chunk_rng(seed: int, chunk_idx: int, salt: int = 0):
    """The chunk's RNG: a pure function of (seed, chunk, salt)."""
    return np.random.default_rng([int(seed), int(chunk_idx), int(salt)])


def _draw_mix_indices(rng, n_mixes: int, apps_per_mix: int, balanced: bool,
                      fill_p: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized mix drawing -> (n_mixes, apps_per_mix) int32 indices:
    one app per sensitivity class, then the fill (biased by ``fill_p``,
    the diurnal knob), then a per-row shuffle.  Not stream-compatible with
    :func:`random_mixes`."""
    n_apps = len(APP_NAMES)
    cols: List[np.ndarray] = []
    if balanced:
        if apps_per_mix < len(_BUCKET_INDICES):
            raise ValueError(
                f"balanced mixes need >= {len(_BUCKET_INDICES)} apps per mix")
        for bucket in _BUCKET_INDICES:
            picks = rng.integers(0, len(bucket), size=n_mixes)
            cols.append(bucket[picks])
    fill = apps_per_mix - len(cols)
    if fill > 0:
        if fill_p is None:
            filler = rng.integers(0, n_apps, size=(n_mixes, fill))
        else:
            filler = rng.choice(n_apps, size=(n_mixes, fill), p=fill_p)
        cols.append(filler.T)
    idx = np.vstack(cols).T.astype(np.int32)
    # Per-row shuffle so class picks don't sit in fixed slots.
    return rng.permuted(idx, axis=1)


def mix_index_chunk(seed: int, chunk_idx: int, chunk_size: int,
                    apps_per_mix: int = 16,
                    balanced: bool = True) -> np.ndarray:
    """One chunk of random mixes as a ``(chunk_size, apps_per_mix)`` int32
    index array into ``APP_NAMES``, derived from ``(seed, chunk_idx)``
    alone: chunk c is the same array whether the run started cold, resumed
    from a checkpoint, or regenerated just that chunk."""
    rng = _chunk_rng(seed, chunk_idx)
    return _draw_mix_indices(rng, chunk_size, apps_per_mix, balanced)


def iter_mix_index_chunks(n_mixes: int, chunk_size: int, *, seed: int = 0,
                          apps_per_mix: int = 16,
                          balanced: bool = True) -> Iterator[np.ndarray]:
    """``n_mixes`` mixes as a sequence of index-array chunks; the last
    chunk is truncated to ``n_mixes`` in total."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    n_chunks = -(-n_mixes // chunk_size)
    for c in range(n_chunks):
        chunk = mix_index_chunk(seed, c, chunk_size, apps_per_mix, balanced)
        remain = n_mixes - c * chunk_size
        yield chunk[:remain] if remain < chunk_size else chunk


def params_from_indices(idx: np.ndarray) -> Dict[str, np.ndarray]:
    """App-index arrays -> the model-parameter dict (each field (M, n)),
    the input of :func:`repro_torch.sim.apps.from_numpy`."""
    idx = np.asarray(idx)
    if idx.ndim != 2:
        raise ValueError(f"expected (n_mixes, apps_per_mix), got {idx.shape}")
    gathered = _PARAM_MATRIX[idx]        # (M, n, F)
    return {field: np.ascontiguousarray(gathered[..., j])
            for j, field in enumerate(MODEL_FIELDS)}


def names_from_indices(idx: np.ndarray) -> List[List[str]]:
    """Index arrays -> name lists (for parity against the list-based API)."""
    return [[APP_NAMES[int(i)] for i in row] for row in np.asarray(idx)]


# --------------------------------------------------------------------- #
# Streaming scenario service
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class StreamScenario:
    """Scenario knobs of the streaming sweep service.

    ``popularity="zipf"`` draws each mix from a deterministic template
    catalog with Zipf(``zipf_exponent``) rank popularity.
    ``diurnal_period_chunks > 0`` sweeps a sinusoidal phase over the
    stream that biases the fill draw toward cache-sensitive apps at the
    peak and bandwidth-sensitive apps in the trough.
    ``phase_app_fraction > 0`` makes that fraction of each mix's slots
    phase-changing: their miss-curve parameters drift sinusoidally per
    chunk (period ``phase_period_chunks``, relative amplitude
    ``phase_amplitude``).
    """

    apps_per_mix: int = 16
    balanced: bool = True
    popularity: str = "uniform"          # "uniform" | "zipf"
    zipf_exponent: float = 1.2
    catalog_size: int = 4096
    diurnal_period_chunks: int = 0       # 0 = no diurnal modulation
    diurnal_amplitude: float = 0.5
    phase_app_fraction: float = 0.0      # 0 = no phase-changing apps
    phase_amplitude: float = 0.25
    phase_period_chunks: int = 8

    def __post_init__(self):
        if self.popularity not in ("uniform", "zipf"):
            raise ValueError(
                f"unknown popularity model {self.popularity!r}")
        if not 0.0 <= self.phase_app_fraction <= 1.0:
            raise ValueError("phase_app_fraction must be in [0, 1]")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1]")
        if self.popularity == "zipf" and self.zipf_exponent <= 1.0:
            raise ValueError("zipf_exponent must be > 1")


def _diurnal_fill_p(scenario: StreamScenario,
                    chunk_idx: int) -> Optional[np.ndarray]:
    """Fill-draw probabilities for this chunk's diurnal phase (or None)."""
    if scenario.diurnal_period_chunks <= 0:
        return None
    phase = math.sin(
        2.0 * math.pi * chunk_idx / scenario.diurnal_period_chunks)
    bias = scenario.diurnal_amplitude * phase
    w = np.ones(len(APP_NAMES), dtype=np.float64)
    # Day (+phase): cache-sensitive demand; night (-phase): bandwidth.
    w[_CACHE_SENSITIVE] *= 1.0 + max(bias, 0.0)
    w[_BW_SENSITIVE] *= 1.0 + max(-bias, 0.0)
    return w / w.sum()


#: The largest rank :func:`_zipf` returns (numpy's ``RAND_INT_MAX``).
_ZIPF_MAX = float(np.iinfo(np.int64).max)


def _zipf(rng, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0 draws it: the rejection sampler
    of its ``random_zipf``, two standard uniforms per attempt.

    Newer numpy draws other ranks from the same generator state (2.3.5
    differs from 2.0.2 in 4 of the first 16 ranks of the bench smoke's
    chunk 0), and the ranks pick each zipf chunk's mixes: the stream's
    identity, and the reference's goldens and checkpoints, rest on these.  The uniforms are taken from
    ``rng`` in blocks, so ``rng`` is left past what was used and must not
    draw again.
    """
    am1 = a - 1.0
    b = 2.0 ** am1
    out = np.empty(size, dtype=np.int64)
    block = iter(())
    n = 0
    while n < size:
        try:
            u, v = next(block), next(block)
        except StopIteration:
            block = iter(rng.random(2 * (size - n) + 16).tolist())
            continue
        try:
            x = math.floor(math.pow(1.0 - u, -1.0 / am1))
        except OverflowError:       # C's pow gives inf: rejected there too
            continue
        if x > _ZIPF_MAX or x < 1.0:
            continue
        t = math.pow(1.0 + 1.0 / x, am1)
        if v * x * (t - 1.0) / (b - 1.0) <= t / b:
            out[n] = int(x)
            n += 1
    return out


def _catalog_rows(scenario: StreamScenario, seed: int,
                  catalog_ids: np.ndarray) -> np.ndarray:
    """Template-catalog mixes for ``catalog_ids``, each row a pure
    function of (seed, catalog id), generated only for the ids drawn."""
    uniq, inverse = np.unique(catalog_ids, return_inverse=True)
    rows = np.empty((len(uniq), scenario.apps_per_mix), dtype=np.int32)
    for j, cid in enumerate(uniq):
        rng = _chunk_rng(seed, int(cid), salt=0xCA7A)
        rows[j] = _draw_mix_indices(
            rng, 1, scenario.apps_per_mix, scenario.balanced)[0]
    return rows[inverse]


def scenario_chunk(scenario: StreamScenario, seed: int, chunk_idx: int,
                   chunk_size: int) -> Dict[str, np.ndarray]:
    """One scenario chunk: the model-parameter dict of
    :func:`params_from_indices` with the phase drift applied, plus the raw
    ``(chunk_size, apps_per_mix)`` index array under ``"mix_indices"``.
    Deterministic in ``(scenario, seed, chunk_idx, chunk_size)``."""
    if scenario.popularity == "zipf":
        rng = _chunk_rng(seed, chunk_idx, salt=0x21BF)
        ranks = _zipf(rng, scenario.zipf_exponent, chunk_size)
        catalog_ids = (ranks - 1) % scenario.catalog_size
        idx = _catalog_rows(scenario, seed, catalog_ids)
    else:
        rng = _chunk_rng(seed, chunk_idx)
        idx = _draw_mix_indices(
            rng, chunk_size, scenario.apps_per_mix, scenario.balanced,
            fill_p=_diurnal_fill_p(scenario, chunk_idx))
    params = params_from_indices(idx)

    if scenario.phase_app_fraction > 0.0:
        # Phase-changing apps: a fixed subset of slots per mix drifts its
        # miss curve sinusoidally across chunks (mpki_min_alloc and
        # mpki_floor multiplied, ws_units divided by the factor).
        sel_rng = _chunk_rng(seed, 0, salt=0xFA5E)
        n = scenario.apps_per_mix
        n_phase = max(1, int(round(scenario.phase_app_fraction * n)))
        slots = sel_rng.permutation(n)[:n_phase]
        offsets = sel_rng.uniform(0.0, 2.0 * math.pi, size=n_phase)
        drift = scenario.phase_amplitude * np.sin(
            2.0 * math.pi * chunk_idx / scenario.phase_period_chunks
            + offsets)
        factor = np.ones(n, dtype=np.float64)
        factor[slots] = 1.0 + drift
        params["mpki_min_alloc"] = params["mpki_min_alloc"] * factor
        params["mpki_floor"] = params["mpki_floor"] * factor
        params["ws_units"] = params["ws_units"] / factor
    params["mix_indices"] = idx
    return params
