#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with every one of its functions timed, to find
where the smoke's seconds go.

    python3 tools/smoke_timing.py [--skip PHASE ...]

Every function of ``chip_smoke.py`` (and ``run_sweep``, the plain greedy,
``models.build`` and the profiler's ``__exit__`` and ``events``) is
wrapped in a timer that adds its inclusive seconds to the phase it ran
in (a recursive call counts once).  After each phase, where the smoke
probes device memory, one line is printed:

    TIMING {"phase": ..., "seconds": ..., "top": [[function, s, calls]]}

with the phase's wall seconds and its 25 costliest functions (inclusive,
so a function's callers count its seconds too).  ``--skip mesh pipe``
replaces those phases by ones that do nothing (any of phases 17-20:
shard, mesh, pipe, dry).  Needs the card, as the smoke does; the exit
code is the smoke's.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: Helpers too small to time.
UNTIMED = {"main", "emit", "check", "card_line", "memory_probe", "sync"}
#: Phases that may be left out (they return launch counts by kernel name),
#: by the smoke's function for each.
SKIPPABLE = {"shard": "sharding_phase", "mesh": "mesh_phase",
             "pipe": "pipe_phase", "dry": "dry_phase"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=sorted(SKIPPABLE), help="phases to leave out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    seconds = collections.defaultdict(float)
    calls = collections.Counter()
    running = collections.Counter()
    phase = {"name": "start", "t0": time.perf_counter()}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            if running[name]:
                return fn(*a, **kw)
            running[name] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                running[name] -= 1
                seconds[(phase["name"], name)] += time.perf_counter() - t0
                calls[(phase["name"], name)] += 1
        return run

    for name, fn in list(vars(cs).items()):
        if (isinstance(fn, types.FunctionType)
                and fn.__module__ == "chip_smoke" and name not in UNTIMED):
            setattr(cs, name, timed(name, fn))

    probe = cs.memory_probe

    def report(card, after):
        now = time.perf_counter()
        top = sorted(((n, s) for (p, n), s in seconds.items()
                      if p == phase["name"]), key=lambda r: -r[1])[:25]
        print("TIMING", json.dumps({
            "phase": after, "seconds": now - phase["t0"],
            "top": [[n, s, calls[(phase["name"], n)]] for n, s in top]}),
            flush=True)
        probe(card, after)
        phase.update(name=after, t0=time.perf_counter())

    cs.memory_probe = report

    import repro_torch.kernels.lookahead_greedy as lg
    import repro_torch.models as models
    import repro_torch.sim as sim
    import torch.profiler

    sim.run_sweep = timed("run_sweep", sim.run_sweep)
    lg.lookahead_greedy_plain = timed("greedy_plain",
                                      lg.lookahead_greedy_plain)
    models.build = timed("models.build", models.build)
    prof = torch.profiler.profile
    prof.events = timed("profiler.events", prof.events)
    prof.__exit__ = timed("profiler.__exit__", prof.__exit__)
    for name in args.skip:
        setattr(cs, SKIPPABLE[name], lambda card, *rest: {})
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
