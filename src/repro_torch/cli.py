"""The port's CLI front door: ``python -m repro_torch <command> ...``.

  PYTHONPATH=src python -m repro_torch sim --scenario diurnal-mixed --seed 0
  PYTHONPATH=src python -m repro_torch serve --scenario serving-slo
  PYTHONPATH=src python -m repro_torch profile --suite smoke --out matrix.json

`sim`, `serve` and `profile` are ported; `repro`'s `inspect`, `diff` and
`chaos` wait for the durability plane, and `bench` for the benchmarks.
The flags are `repro`'s, with these differences:

* ``--device`` places the card work (the speed predictor's training, the
  torch tick engine, the measured matrix, the catalog): the CUDA card by
  default, where a run without one raises; ``--device cpu`` runs the plain
  path.  `profile` has it in place of ``--no-interpret``.
* ``--engine`` takes ``numpy`` or ``torch`` (`repro`'s ``xla``) and defaults
  to ``torch``, so the tick core runs on ``--device``; `repro` defaults to
  the scenario's ``numpy``.  Reports are byte-identical across engines, so
  this changes no artifact.
* The observability and durability flags (``--metrics-out`` and the rest,
  ``--durable``, ``--resume``, ``--verify-manifest``) are not ported yet,
  and argparse refuses them.

Stdout carries only the artifact's bytes, equal to `python -m repro`'s for
the same flags and predictor; wall-clock chatter goes to stderr only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

_USAGE = """\
usage: python -m repro_torch <command> [options]

commands:
  sim       run a cluster scenario -> deterministic JSON report
  serve     run a request-level serving scenario (serving-plane focus)
  profile   run a pair-profiling campaign -> speed-matrix artifact

`python -m repro_torch <command> --help` shows each command's flags.
"""


def _add_device_flags(ap) -> None:
    ap.add_argument("--engine", default="torch", choices=("numpy", "torch"),
                    help="tick-engine backend (default: torch, on "
                         "--device); reports are byte-identical across "
                         "engines")
    ap.add_argument("--device", default=None,
                    help="torch device for the predictor, the torch tick "
                         "engine and a measured matrix (default: the CUDA "
                         "card; 'cpu' runs the plain path)")


# --------------------------------------------------------------------- sim
def sim_main(argv=None, *, prog="python -m repro_torch sim") -> int:
    """Scenario runner: one control-plane campaign -> JSON report."""
    from repro_torch import resolve_device
    from repro_torch.cluster.control import check_schema, run_scenario
    from repro_torch.cluster.scenario import SCENARIOS, scenario_by_name
    from repro_torch.policies import available, resolve

    ap = argparse.ArgumentParser(
        prog=prog, description=sim_main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="smoke",
                    help="registry name (see --list)")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--hours", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--policy", default=None,
                    help="sharing-policy override (see --list-policies)")
    _add_device_flags(ap)
    ap.add_argument("--tick", type=float, default=None)
    gx = ap.add_mutually_exclusive_group()
    gx.add_argument("--graceful-exit", dest="graceful", action="store_true",
                    default=None)
    gx.add_argument("--no-graceful-exit", dest="graceful",
                    action="store_false")
    ap.add_argument("--out", default=None, help="write report JSON here "
                    "(default: stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--list-policies", action="store_true",
                    help="list registered sharing policies and exit")
    ap.add_argument("--check-schema", metavar="REPORT.json", default=None,
                    help="validate an existing report file and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name, sc in sorted(SCENARIOS.items()):
            print(f"{name:16s} {sc.description}")
        return 0
    if args.list_policies:
        for name in available():
            pol = resolve(name)
            tags = "".join(t for t, on in
                           (("[needs-predictor] ", pol.needs_predictor),
                            ("[no-scheduling] ", not pol.wants_scheduling))
                           if on)
            print(f"{name:18s} {tags}{pol.description}")
        return 0
    if args.check_schema:
        return _check_schema_file(args.check_schema, check_schema)

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    report = run_scenario(
        scenario_by_name(args.scenario), device=device,
        n_devices=args.devices, hours=args.hours, seed=args.seed,
        policy=args.policy, tick_s=args.tick, graceful_exit=args.graceful,
        engine=args.engine)
    _emit_json(report, args.out)
    wall = time.perf_counter() - t0
    s = report["sim"]
    print(f"[{report['scenario']['name']}] {s['policy']} "
          f"n={report['scenario']['n_devices']} "
          f"{report['scenario']['hours']}h: finished "
          f"{s['n_finished']}/{s['n_jobs']} jobs, slowdown "
          f"{s['avg_slowdown']:.3f}x, errors {s['errors_propagated']}"
          f"/{s['errors_injected']} propagated, "
          f"{report['events']['n_events']} events "
          f"({wall:.1f}s wall, {args.engine} engine on {device})",
          file=sys.stderr)
    _emit_serving_note(report)
    return 0


# ------------------------------------------------------------------- serve
def serve_main(argv=None) -> int:
    """Serving-plane runner: a scenario with request-level accounting.

    Same report pipeline as ``sim`` (full scenario report to stdout/--out),
    defaulting to the ``serving-slo`` scenario and exposing the serving
    knobs (arrival kind, load, admission policy, request-size skew) as
    flags.  A scenario without a serving section gets the default
    :class:`~repro_torch.serving_plane.ServingConfig` attached.
    """
    import dataclasses

    from repro_torch import resolve_device
    from repro_torch.cluster.control import check_schema, run_scenario
    from repro_torch.cluster.scenario import scenario_by_name
    from repro_torch.serving_plane import (ARRIVAL_KINDS, ServingConfig,
                                           admission_available)

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch serve", description=serve_main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="serving-slo")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--hours", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    _add_device_flags(ap)
    ap.add_argument("--arrivals", default=None, choices=ARRIVAL_KINDS,
                    help="arrival-process kind override")
    ap.add_argument("--load", type=float, default=None,
                    help="target mean utilization vs nominal capacity")
    ap.add_argument("--admission", default=None,
                    help=f"admission policy ({admission_available()})")
    ap.add_argument("--request-size-sigma", type=float, default=None,
                    help="lognormal request-size skew (0 = uniform sizes)")
    ap.add_argument("--out", default=None, help="write report JSON here "
                    "(default: stdout)")
    ap.add_argument("--check-schema", metavar="REPORT.json", default=None,
                    help="validate an existing report file and exit")
    args = ap.parse_args(argv)

    if args.check_schema:
        return _check_schema_file(args.check_schema, check_schema)

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    sc = scenario_by_name(args.scenario)
    serving = sc.serving if sc.serving is not None else ServingConfig()
    overrides = {k: v for k, v in (
        ("arrivals", args.arrivals), ("load", args.load),
        ("admission", args.admission),
        ("request_size_sigma", args.request_size_sigma))
        if v is not None}
    if overrides:
        serving = dataclasses.replace(serving, **overrides)
    report = run_scenario(
        sc, device=device, n_devices=args.devices, hours=args.hours,
        seed=args.seed, engine=args.engine, serving=serving)
    _emit_json(report, args.out)
    wall = time.perf_counter() - t0
    _emit_serving_note(report)
    print(f"[{report['scenario']['name']}] ({wall:.1f}s wall, "
          f"{args.engine} engine on {device})", file=sys.stderr)
    return 0


# ----------------------------------------------------------------- profile
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
        return _check_schema_file(args.check_schema, check_schema)

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


# ----------------------------------------------------------------- helpers
def _emit_json(report: dict, out_path) -> None:
    out = json.dumps(report, indent=2, sort_keys=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(out + "\n")
        print(f"wrote {out_path}", file=sys.stderr)
    else:
        print(out)


def _emit_serving_note(report: dict) -> None:
    serving = report.get("serving")
    if not serving:
        return
    for svc, row in sorted(serving["services"].items()):
        print(f"[serving] {svc:10s} p50 {row['p50_ms']:.1f}ms "
              f"p99 {row['p99_ms']:.1f}ms slo {row['slo_ms']:.0f}ms "
              f"attain {row['slo_attainment']:.4f} "
              f"shed {row['shed']}/{row['arrived']}", file=sys.stderr)
    tot = serving["total"]
    print(f"[serving] total      p50 {tot['p50_ms']:.1f}ms "
          f"p99 {tot['p99_ms']:.1f}ms attain {tot['slo_attainment']:.4f} "
          f"shed {tot['shed']}/{tot['arrived']}", file=sys.stderr)


def _check_schema_file(path: str, checker) -> int:
    with open(path) as f:
        problems = checker(json.load(f))
    for p in problems:
        print(f"SCHEMA: {p}", file=sys.stderr)
    print("schema " + ("FAIL" if problems else "OK"), file=sys.stderr)
    return 1 if problems else 0


# ---------------------------------------------------------------- dispatch
COMMANDS = {"sim": sim_main, "serve": serve_main, "profile": profile_main}


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
