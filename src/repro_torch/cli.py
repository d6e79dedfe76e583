"""The port's CLI front door: ``python -m repro_torch <command> ...``.

  PYTHONPATH=src python -m repro_torch profile --suite smoke --out matrix.json

Only `profile` is ported (`repro.cli`'s other commands wait for the control
plane).  Its flags are `repro`'s, with ``--device`` in place of
``--no-interpret``; the artifact bytes on stdout are the speed matrix, and
wall-clock chatter goes to stderr only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

_USAGE = """\
usage: python -m repro_torch <command> [options]

commands:
  profile   run a pair-profiling campaign -> speed-matrix artifact

`python -m repro_torch <command> --help` shows each command's flags.
"""


def profile_main(argv=None, *, prog="python -m repro_torch profile") -> int:
    """Pair-profiling campaign.

    Executes the workload catalog (the CUDA kernels on the card, or their
    plain versions with --device cpu), profiles every online × offline pair
    across the suite's SM-share sweep, and writes the speed-matrix artifact.
    """
    from repro_torch import resolve_device
    from repro_torch.profiling.harness import SUITES, build_speed_matrix
    from repro_torch.profiling.matrix import check_schema
    from repro_torch.profiling.workloads import build_catalog

    ap = argparse.ArgumentParser(
        prog=prog, description=profile_main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--suite", default="smoke", choices=sorted(SUITES),
                    help="profiling campaign (smoke: CI-sized; full: dense "
                         "share sweep)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the speed-matrix JSON here (default: stdout)")
    ap.add_argument("--device", default=None,
                    help="torch device to execute the catalog on (default: "
                         "the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--list", action="store_true",
                    help="list the workload catalog and exit")
    ap.add_argument("--check-schema", metavar="MATRIX.json", default=None,
                    help="validate an existing artifact and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name, w in build_catalog().items():
            print(f"{name:16s} {w.role:8s} seed={w.seed:<4d} "
                  f"warmup={w.warmup} steps={w.steps} "
                  f"cost={w.cost_s() * 1e3:.4f}ms "
                  f"flops/step={w.flops_per_step:.3g}")
        return 0
    if args.check_schema:
        with open(args.check_schema) as f:
            problems = check_schema(json.load(f))
        for p in problems:
            print(f"SCHEMA: {p}", file=sys.stderr)
        print("schema " + ("FAIL" if problems else "OK"), file=sys.stderr)
        return 1 if problems else 0

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    matrix = build_speed_matrix(args.suite, args.seed, device=device)
    wall = time.perf_counter() - t0
    out = matrix.to_json()
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(out, end="")
    for name, rec in matrix.records.items():
        print(f"[exec] {name:16s} {rec.steps_executed} steps, "
              f"{rec.wall_ms_per_step:.2f} ms/step wall on {device}, "
              f"checksum {rec.checksum}", file=sys.stderr)
    n_cells = sum(len(p["shares"]) for p in matrix.pairs)
    print(f"[{args.suite}] {len(matrix.workloads)} workloads, "
          f"{len(matrix.pairs)} pairs, {n_cells} cells, quantum "
          f"{matrix.data['quantum_ms'] * 1e3:.2f}us ({wall:.1f}s wall)",
          file=sys.stderr)
    return 0


COMMANDS = {"profile": profile_main}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_USAGE, end="")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    fn = COMMANDS.get(cmd)
    if fn is None:
        print(f"unknown command {cmd!r}; available: "
              f"{' '.join(sorted(COMMANDS))}", file=sys.stderr)
        return 2
    return int(fn(rest) or 0)
