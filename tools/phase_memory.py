#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with the device-memory probe after
every phase, for a checkout whose smoke predates the probe.

    python3 tools/phase_memory.py [CHECKOUT]

``CHECKOUT`` (default: this one) is the root of a checkout of the
repository.  Every ``*_phase`` function of its ``chip_smoke.py`` is
wrapped so that, once the phase returns, this checkout's
``chip_smoke.memory_probe`` prints one ``{"phase": "memory", ...}`` line:
the bytes allocated on the card, the bytes a collector pass then frees
(memory that reference cycles held), and the port's classes among the
objects that pass found.  A smoke that already probes runs as it is.  The
exit code is the smoke's.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv) -> int:
    target = Path(argv[0]).resolve() if argv else ROOT
    smoke = load(target / "chip_smoke.py", "target_chip_smoke")
    if not hasattr(smoke, "memory_probe"):
        own = load(ROOT / "chip_smoke.py", "own_chip_smoke")
        card = own.card_line()

        def probed(name, fn):
            def run(*args, **kwargs):
                out = fn(*args, **kwargs)
                own.memory_probe(card, name[:-len("_phase")])
                return out
            return run

        for name in [n for n in vars(smoke) if n.endswith("_phase")]:
            setattr(smoke, name, probed(name, getattr(smoke, name)))
    return smoke.main()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
