"""Streaming sweep service CLI of the PyTorch/CUDA port — the operator's
entry point (counterpart of ``tools/stream_sweep.py``, the same flags and
exit rule, plus ``--device`` and ``--overlap``: the port's streams run
serially by default, where the reference's overlap).

Runs (or resumes) a fault-tolerant chunked sweep over a scenario stream
(:mod:`repro_torch.sim.stream_sweep`) on the CUDA card (``--device cpu``
for the CPU) and prints the final ``StreamReport`` as JSON.  Typical uses:

  # a million-mix overnight run with checkpoints every 32 chunks
  PYTHONPATH=src python tools/torch_stream_sweep.py --mixes 1000000 \\
      --chunk-size 2048 --managers baseline,CBP --popularity zipf \\
      --checkpoint-dir results/stream_ck --checkpoint-every 32

  # the run died (OOM, preemption, SIGKILL): resume from the last
  # complete checkpoint; the final aggregates are bit-identical to an
  # uninterrupted run of the same command
  PYTHONPATH=src python tools/torch_stream_sweep.py ... --resume

  # rehearse the failure paths against a fault plan (JSON list of
  # {"kind","chunk","count","seconds"} dicts, see
  # repro_torch.runtime.faultinject)
  PYTHONPATH=src python tools/torch_stream_sweep.py --mixes 1024 \\
      --fault-plan faults.json

Exit status is non-zero when coverage is below ``--min-coverage``
(default 1.0): a degraded run is visible to the calling automation, never
a silent truncation.  The checkpoints are the reference CLI's: a run
of either can resume the other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mixes", type=int, default=100_000)
    ap.add_argument("--chunk-size", type=int, default=1024)
    ap.add_argument("--managers", default=None,
                    help="comma-separated Table-3 manager names "
                         "(default: all)")
    ap.add_argument("--total-ms", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--apps-per-mix", type=int, default=16)
    # scenario knobs
    ap.add_argument("--popularity", choices=("uniform", "zipf"),
                    default="uniform")
    ap.add_argument("--zipf-exponent", type=float, default=1.2)
    ap.add_argument("--catalog-size", type=int, default=4096)
    ap.add_argument("--diurnal-period-chunks", type=int, default=0)
    ap.add_argument("--diurnal-amplitude", type=float, default=0.5)
    ap.add_argument("--phase-app-fraction", type=float, default=0.0)
    ap.add_argument("--phase-period-chunks", type=int, default=8)
    # robustness knobs
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--on-divergence", choices=("quarantine", "raise"),
                    default="quarantine")
    ap.add_argument("--max-consecutive-quarantines", type=int, default=8)
    overlap = ap.add_mutually_exclusive_group()
    overlap.add_argument("--overlap", dest="overlap", action="store_true",
                         default=None,
                         help="generate the next chunk while a worker "
                              "thread runs this one")
    overlap.add_argument("--no-overlap", dest="overlap",
                         action="store_false",
                         help="serial chunk dispatch (the default)")
    ap.add_argument("--fault-plan", default=None,
                    help="JSON file of fault dicts (testing/rehearsal)")
    ap.add_argument("--min-coverage", type=float, default=1.0,
                    help="exit non-zero below this coverage fraction")
    ap.add_argument("--out", default=None, help="write report JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def run_resources(device, report) -> dict:
    """The run's device, mixes per second, peak device memory (the card
    only) and the process's peak resident set."""
    import resource

    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "mixes_per_s": report.mixes_covered / report.wall_s,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024,
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch.runtime.faultinject import FaultPlan
    from repro_torch.sim.stream_sweep import (
        RetryPolicy,
        StreamConfig,
        run_stream,
    )
    from repro_torch.sim.workloads import StreamScenario

    scenario = StreamScenario(
        apps_per_mix=args.apps_per_mix,
        popularity=args.popularity,
        zipf_exponent=args.zipf_exponent,
        catalog_size=args.catalog_size,
        diurnal_period_chunks=args.diurnal_period_chunks,
        diurnal_amplitude=args.diurnal_amplitude,
        phase_app_fraction=args.phase_app_fraction,
        phase_period_chunks=args.phase_period_chunks,
    )
    cfg = StreamConfig(
        n_mixes=args.mixes,
        chunk_size=args.chunk_size,
        managers=(tuple(m.strip() for m in args.managers.split(","))
                  if args.managers else None),
        total_ms=args.total_ms,
        seed=args.seed,
        scenario=scenario,
        retry=RetryPolicy(max_retries=args.max_retries),
        on_divergence=args.on_divergence,
        max_consecutive_quarantines=args.max_consecutive_quarantines,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    plan = None
    if args.fault_plan:
        plan = FaultPlan.from_dicts(
            json.loads(pathlib.Path(args.fault_plan).read_text()))
    report = run_stream(cfg, fault_plan=plan, resume=args.resume,
                        overlap=bool(args.overlap), device=args.device)
    payload = report.to_dict()
    payload["run"] = run_resources(args.device, report)
    payload["config"] = {
        **{k: v for k, v in dataclasses.asdict(cfg).items()
           if k not in ("scenario", "params", "retry")},
        "scenario": dataclasses.asdict(scenario),
        "fingerprint": cfg.fingerprint(),
    }
    text = json.dumps(payload, indent=1, default=float)
    if args.out:
        pathlib.Path(args.out).write_text(text)
    print(text)
    if report.coverage < args.min_coverage:
        print(f"ERROR: coverage {report.coverage:.4f} < required "
              f"{args.min_coverage} "
              f"(quarantined chunks: {[c for c, _ in report.quarantined]})",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
