"""One device program per call: a function captured once into a CUDA
graph and replayed (the port's counterpart of a jitted JAX program).

:class:`CapturedProgram` runs its function once eagerly on a side stream
of its device (first-use set-up such as a kernel's shared-memory
attribute happens there, outside the capture), captures it on that
stream into one ``torch.cuda.CUDAGraph``, and from then on each
:meth:`~CapturedProgram.run` is one replay on that device.  The function reads its inputs from static tensors
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
        """Warm up on a side stream of the program's device, then capture
        ``fn`` on that stream (raises if the capture fails; the program
        stays uncaptured).  Not on ``torch.cuda.graph``'s default capture
        stream: that is made once, on the device current at its first
        use, and a capture there of another card's work fails."""
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
                with uncounted() as launches, torch.cuda.graph(
                        graph, stream=side):
                    out = self._fn()
            finally:
                if enabled:
                    gc.enable()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        self._graph, self._out, self.launches = graph, out, launches
        self.seconds = {"warmup": t1 - t0, "capture": t2 - t1}

    def run(self) -> torch.Tensor:
        """One replay (capturing first if needed), counted; returns the
        output tensor, valid until the next run."""
        if self._graph is None:
            self.capture()
        out = self.replay()
        self.record()
        return out

    def replay(self) -> torch.Tensor:
        """One replay of the captured graph on the program's device,
        whichever device is current, not counted: threads may replay
        programs of several cards at once (a large graph's launch holds
        its host thread for most of its run), and count them with
        :meth:`record` afterwards, from one thread."""
        with torch.cuda.device(self.device):
            self._graph.replay()
        return self._out

    def record(self) -> None:
        """Count one replay and the kernel launches it made."""
        record_launches(self.launches)
        self._replays.record()
