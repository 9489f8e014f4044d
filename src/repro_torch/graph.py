"""One device program per call: a function captured once into a CUDA
graph and replayed (the port's counterpart of a jitted JAX program).

:class:`CapturedProgram` runs its function once eagerly on a side stream
(first-use set-up such as a kernel's shared-memory attribute happens
there, outside the capture), captures it into one
``torch.cuda.CUDAGraph``, and from then on each :meth:`~CapturedProgram.
run` is one replay.  The function reads its inputs from static tensors
that the caller fills in place before a run, and returns one tensor,
which the graph overwrites at every replay.

A capture that fails raises; nothing here falls back to running the
function eagerly.  Python's garbage collector is run just before the
capture and kept off during it: a dead reference cycle (autograd's
non-reentrant checkpoints leave them after a training step) collected
inside a capture runs finalizers that make CUDA calls a capture forbids,
and the capture fails.  The kernel wrappers count their launches in Python,
where a replay does not reach them, so each replay adds to every counter
what the capture recorded (:func:`repro_torch.core.dispatch.uncounted`).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.dispatch import LaunchCounter, record_launches, uncounted


class CapturedProgram:
    """``fn() -> Tensor`` on a CUDA device, captured at its first
    :meth:`run` and replayed at every run; ``replays`` counts the
    replays."""

    def __init__(self, fn: Callable[[], torch.Tensor], device: torch.device,
                 replays: LaunchCounter):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a cuda device, not "
                             f"{device}")
        self._fn = fn
        self.device = device
        self._replays = replays
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        #: Kernel launches per replay, by counter name.
        self.launches: Dict[str, int] = {}
        #: Host seconds of the eager warm-up and of the capture (with
        #: instantiation), each ended by a device synchronisation.
        self.seconds: Dict[str, float] = {}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def capture(self) -> None:
        """Warm up on a side stream, then capture ``fn`` (raises if the
        capture fails; the program stays uncaptured)."""
        with torch.cuda.device(self.device):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._fn()
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            gc.collect()
            enabled = gc.isenabled()
            gc.disable()
            try:
                with uncounted() as launches, torch.cuda.graph(graph):
                    out = self._fn()
            finally:
                if enabled:
                    gc.enable()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        self._graph, self._out, self.launches = graph, out, launches
        self.seconds = {"warmup": t1 - t0, "capture": t2 - t1}

    def run(self) -> torch.Tensor:
        """One replay (capturing first if needed); returns the output
        tensor, valid until the next run."""
        if self._graph is None:
            self.capture()
        self._graph.replay()
        record_launches(self.launches)
        self._replays.record()
        return self._out
