"""Deterministic seeded fault injection for the streaming sweep service
(copy of :mod:`repro.runtime.faultinject`).

The streaming pipeline (:mod:`repro_torch.sim.stream_sweep`) must survive chunk
dispatch failures, NaN/Inf result poisoning, process death and stragglers.
None of those occur on a healthy CI host, so the pipeline threads a
:class:`FaultPlan` through every layer and the tests/smokes inject each
fault class on purpose:

* ``dispatch_error`` — the chunk's device dispatch raises
  :class:`InjectedDispatchError`; ``count`` consecutive attempts fail, so
  ``count <= max_retries`` exercises retry-with-backoff and
  ``count > max_retries`` exercises quarantine + graceful degradation.
* ``nan_poison`` — the chunk's device-resident results are overwritten
  with NaN *before* the in-trace finite guard runs, so the poisoned chunk
  flows through the same divergence detection a genuinely diverged solve
  would hit.
* ``kill`` — :class:`InjectedProcessKill` (a ``BaseException``, like a
  real ``SIGKILL`` it must not be swallowed by ``except Exception``
  recovery paths) fires at the start of the chunk, simulating process
  death between checkpoints.  Resume harnesses re-run the same plan via
  :meth:`FaultPlan.without_kills` — the crash already happened.
* ``straggle`` — inflates the observed chunk wall time by ``seconds``
  (artificial, no real sleep) so the
  :class:`repro_torch.runtime.fault.StragglerWatchdog` path is testable in
  milliseconds.

Plans are plain data keyed by chunk index: the same plan applied to the
same stream is bit-reproducible, which is what lets the resume-parity CI
gate compare a killed-and-resumed run against an uninterrupted one.
:meth:`FaultPlan.seeded` derives a pseudo-random plan from a seed for
soak-style testing; it is deterministic in (seed, n_chunks, rates).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np

FAULT_KINDS = ("dispatch_error", "nan_poison", "kill", "straggle")


class InjectedFault(RuntimeError):
    """Base class for recoverable injected faults."""


class InjectedDispatchError(InjectedFault):
    """An injected chunk-dispatch failure (retryable)."""


class InjectedProcessKill(BaseException):
    """Simulated process death.

    Deliberately a ``BaseException``: the pipeline's recovery machinery
    catches ``Exception`` and a kill must tear straight through it, the
    way a real ``SIGKILL`` would.  Test harnesses catch it explicitly.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected fault at one chunk.

    ``count`` only applies to ``dispatch_error`` (consecutive failing
    attempts); ``seconds`` only to ``straggle`` (artificial wall
    inflation).
    """

    kind: str
    chunk: int
    count: int = 1
    seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: {FAULT_KINDS}")
        if self.chunk < 0:
            raise ValueError(f"fault chunk must be >= 0, got {self.chunk}")
        if self.kind == "dispatch_error" and self.count < 1:
            raise ValueError("dispatch_error needs count >= 1")


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of injected faults, keyed by chunk index.

    The pipeline calls the ``on_*`` hooks at the matching points; a plan
    with no spec for a chunk is a no-op there, so ``FaultPlan()`` is the
    healthy-run identity.
    """

    specs: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        self.specs = tuple(self.specs)
        self._by_chunk: Dict[str, Dict[int, FaultSpec]] = {
            kind: {} for kind in FAULT_KINDS}
        for spec in self.specs:
            prev = self._by_chunk[spec.kind].setdefault(spec.chunk, spec)
            if prev is not spec:
                raise ValueError(
                    f"duplicate {spec.kind} fault at chunk {spec.chunk}")

    # ------------------------------------------------------------ hooks #

    def on_chunk_start(self, chunk: int) -> None:
        """Raise :class:`InjectedProcessKill` if this chunk is a kill."""
        if chunk in self._by_chunk["kill"]:
            raise InjectedProcessKill(f"injected kill at chunk {chunk}")

    def on_dispatch(self, chunk: int, attempt: int) -> None:
        """Fail dispatch ``attempt`` (0-based) if the plan says so."""
        spec = self._by_chunk["dispatch_error"].get(chunk)
        if spec is not None and attempt < spec.count:
            raise InjectedDispatchError(
                f"injected dispatch failure at chunk {chunk} "
                f"(attempt {attempt + 1}/{spec.count})")

    def poisons(self, chunk: int) -> bool:
        """True when this chunk's results must be NaN-poisoned."""
        return chunk in self._by_chunk["nan_poison"]

    def straggle_seconds(self, chunk: int) -> float:
        """Artificial wall-time inflation for this chunk (0.0 = none)."""
        spec = self._by_chunk["straggle"].get(chunk)
        return float(spec.seconds) if spec is not None else 0.0

    # ---------------------------------------------------------- helpers #

    def without_kills(self) -> "FaultPlan":
        """The same plan minus process kills — what a resumed run uses:
        the death already happened, the surviving faults are still live."""
        return FaultPlan(tuple(s for s in self.specs if s.kind != "kill"))

    def kill_chunks(self) -> List[int]:
        return sorted(self._by_chunk["kill"])

    @classmethod
    def single(cls, kind: str, chunk: int, *, count: int = 1,
               seconds: float = 0.0) -> "FaultPlan":
        return cls((FaultSpec(kind, chunk, count=count, seconds=seconds),))

    @classmethod
    def seeded(cls, seed: int, n_chunks: int, *,
               p_dispatch_error: float = 0.0,
               p_nan_poison: float = 0.0,
               p_straggle: float = 0.0,
               straggle_seconds: float = 1.0,
               max_dispatch_failures: int = 2) -> "FaultPlan":
        """Derive a pseudo-random plan — deterministic in its arguments.

        Kills are never drawn randomly: a kill needs a matching resume
        harness, so it is always placed explicitly.
        """
        rng = np.random.default_rng([int(seed), 0x5EED])
        specs: List[FaultSpec] = []
        draws = rng.random((n_chunks, 3))
        counts = rng.integers(1, max_dispatch_failures + 1, size=n_chunks)
        for c in range(n_chunks):
            if draws[c, 0] < p_dispatch_error:
                specs.append(FaultSpec("dispatch_error", c,
                                       count=int(counts[c])))
            if draws[c, 1] < p_nan_poison:
                specs.append(FaultSpec("nan_poison", c))
            if draws[c, 2] < p_straggle:
                specs.append(FaultSpec("straggle", c,
                                       seconds=straggle_seconds))
        return cls(tuple(specs))

    @classmethod
    def from_dicts(cls, dicts: Iterable[Dict]) -> "FaultPlan":
        """Build a plan from JSON-ish dicts (the CLI's --fault-plan)."""
        return cls(tuple(FaultSpec(**d) for d in dicts))

    def to_dicts(self) -> List[Dict]:
        return [dataclasses.asdict(s) for s in self.specs]


def poison_tree(tree, value: float = float("nan")):
    """Overwrite every array leaf of ``tree`` (nested dicts, lists and
    tuples) with ``value``.

    Tensors stay tensors on their device (``torch.full_like``), so the
    finite guard on the device still sees the poison; numpy arrays stay
    numpy (``np.full_like``).
    """
    import torch

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: poison_tree(v, value) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(poison_tree(v, value) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.full_like(tree, value)
    return np.full_like(np.asarray(tree), value)


__all__ = [
    "FAULT_KINDS", "FaultPlan", "FaultSpec", "InjectedDispatchError",
    "InjectedFault", "InjectedProcessKill", "poison_tree",
]
