"""Kernel launch counters of the port (counterpart of
:mod:`repro.core.dispatch`).

The JAX package counts jitted-program dispatches; the port counts what a
hand-written kernel's wrapper launches.  Each wrapper owns one
:class:`LaunchCounter` and adds one to it where it launches its kernel,
and nowhere else — so a run that resets the counters, drives the main
path and reads them back shows which kernels that path went through.
"""
from __future__ import annotations

from typing import Dict


class LaunchCounter:
    """A plain integer count of one wrapper's kernel launches."""

    def __init__(self, name: str):
        if name in _COUNTERS:
            raise ValueError(f"launch counter {name!r} already exists")
        self.name = name
        self.count = 0
        _COUNTERS[name] = self

    def record(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


_COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset."""
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()
