"""Kernel launch counters of the port (counterpart of
:mod:`repro.core.dispatch`).

The JAX package counts jitted-program dispatches; the port counts what a
hand-written kernel's wrapper launches.  Each wrapper owns one
:class:`LaunchCounter` and adds one to it where it launches its kernel,
and nowhere else — so a run that resets the counters, drives the main
path and reads them back shows which kernels that path went through.  A
CUDA graph's capture launches nothing, so it counts nothing
(:func:`uncounted`); each replay adds the launches it captured
(:func:`record_launches`, from :class:`repro_torch.graph.
CapturedProgram`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator


class LaunchCounter:
    """A plain integer count of one wrapper's kernel launches."""

    def __init__(self, name: str):
        if name in _COUNTERS:
            raise ValueError(f"launch counter {name!r} already exists")
        self.name = name
        self.count = 0
        _COUNTERS[name] = self

    def record(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> None:
        self.count = 0


_COUNTERS: Dict[str, LaunchCounter] = {}


#: Replays of a captured Fig. 8 knob schedule
#: (:func:`repro_torch.runtime.plant.run_fused_schedule`): one per run on
#: the card.
SCHEDULE_GRAPH_REPLAYS = LaunchCounter("schedule_graph")

#: Runs of the serving graph engine's interval program
#: (:class:`repro_torch.serving.engine_graph.GraphServingEngine`): one per
#: block of groups per reconfiguration interval, a CUDA-graph replay on
#: the card and an eager run on the CPU (the port's counterpart of the
#: reference engine's ``record_dispatch``, one an interval at one block).
SERVE_GRAPH_REPLAYS = LaunchCounter("serve_graph")

#: Runs of the serving graph engine's reconfiguration program: one per
#: reconfiguration a block runs, after its interval program.
SERVE_RECONFIG_REPLAYS = LaunchCounter("serve_reconfig")


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset."""
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()


@contextlib.contextmanager
def uncounted() -> Iterator[Dict[str, int]]:
    """Run a block whose wrapper calls launch nothing, as in a CUDA graph
    capture: on exit every counter is back where it was, and the yielded
    dict holds what each counter would have gained (nonzero entries
    only), for :func:`record_launches` to add at each replay."""
    before = launch_counts()
    gained: Dict[str, int] = {}
    try:
        yield gained
    finally:
        for name, c in _COUNTERS.items():
            if c.count != before.get(name, 0):
                gained[name] = c.count - before.get(name, 0)
            c.count = before.get(name, 0)


def record_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (as :func:`uncounted` yields them) to the counters."""
    for name, n in counts.items():
        _COUNTERS[name].record(n)
