"""The port's CLI front door: ``python -m repro_torch <command> ...``.

  PYTHONPATH=src python -m repro_torch sim --scenario diurnal-mixed --seed 0
  PYTHONPATH=src python -m repro_torch serve --scenario serving-slo
  PYTHONPATH=src python -m repro_torch profile --suite smoke --out matrix.json
  PYTHONPATH=src python -m repro_torch sim --durable RUN --metrics-out m.jsonl
  PYTHONPATH=src python -m repro_torch inspect RUN --tick 30
  PYTHONPATH=src python -m repro_torch chaos --scenario chaos-storm

`sim`, `serve`, `profile`, `inspect`, `diff` and `chaos` are ported, with
the observability (``--metrics-out`` and the rest) and durability
(``--durable``, ``--resume``, ``--verify-manifest``) flags, and so are the
deprecated delegates ``python -m repro_torch.cluster.run`` (``sim``) and
``python -m repro_torch.profiling.run`` (``profile``); `bench` waits for
the benchmarks.  The flags are `repro`'s, with these differences:

* ``--device`` places the card work (the speed predictor's training, the
  torch tick engine, the measured matrix, the catalog): the CUDA card by
  default, where a run without one raises; ``--device cpu`` runs the plain
  path.  Every command that builds a control plane has it (`sim`, `serve`,
  `inspect`, `chaos`, and ``--resume``); `profile` has it in place of
  ``--no-interpret``.  `diff`, ``--verify-manifest``, ``--check-schema``
  and the listings read files only and need no device.
* ``--engine`` takes ``numpy`` or ``torch`` (`repro`'s ``xla``) and defaults
  to ``torch``, so the tick core runs on ``--device``; `repro` defaults to
  the scenario's ``numpy``.  Reports and obs artifacts are byte-identical
  across engines, so this changes none of them (a durable run's
  ``run.json`` records the engine).

Stdout carries only the artifact's bytes, equal to `python -m repro`'s for
the same flags and predictor; notes and wall-clock chatter go to stderr.
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
  inspect   time-travel a durable run to a tick and summarize its state
  diff      pinpoint the first divergent WAL event between two runs
  chaos     run a chaos campaign and verify the survivability invariants

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
    _add_obs_flags(ap)
    _add_durability_flags(ap)
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
    if args.list_alert_rules:
        return _list_alert_rules()
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
    if args.verify_manifest:
        return _verify_manifest_file(args.verify_manifest)

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    if args.resume:
        report = _durable_resume(args.resume, device)
        if report is None:
            return 2
    else:
        sc = scenario_by_name(args.scenario)
        if args.durable:
            report = _durable_run(
                sc.with_overrides(
                    n_devices=args.devices, hours=args.hours,
                    seed=args.seed, policy=args.policy, tick_s=args.tick,
                    graceful_exit=args.graceful, engine=args.engine),
                args, device)
        else:
            report = run_scenario(
                sc, device=device, n_devices=args.devices, hours=args.hours,
                seed=args.seed, policy=args.policy, tick_s=args.tick,
                graceful_exit=args.graceful, engine=args.engine,
                obs=_obs_config(args))
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
          f"({wall:.1f}s wall, {_engine_of(args)} engine on {device})",
          file=sys.stderr)
    _emit_serving_note(report)
    _emit_obs_note(report)
    _emit_incidents_note(report)
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
    _add_obs_flags(ap)
    _add_durability_flags(ap)
    ap.add_argument("--check-schema", metavar="REPORT.json", default=None,
                    help="validate an existing report file and exit")
    args = ap.parse_args(argv)

    if args.list_alert_rules:
        return _list_alert_rules()
    if args.check_schema:
        return _check_schema_file(args.check_schema, check_schema)
    if args.verify_manifest:
        return _verify_manifest_file(args.verify_manifest)

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    if args.resume:
        report = _durable_resume(args.resume, device)
        if report is None:
            return 2
    else:
        sc = scenario_by_name(args.scenario)
        serving = sc.serving if sc.serving is not None else ServingConfig()
        overrides = {k: v for k, v in (
            ("arrivals", args.arrivals), ("load", args.load),
            ("admission", args.admission),
            ("request_size_sigma", args.request_size_sigma))
            if v is not None}
        if overrides:
            serving = dataclasses.replace(serving, **overrides)
        if args.durable:
            report = _durable_run(
                sc.with_overrides(
                    n_devices=args.devices, hours=args.hours,
                    seed=args.seed, engine=args.engine, serving=serving),
                args, device)
        else:
            report = run_scenario(
                sc, device=device, n_devices=args.devices, hours=args.hours,
                seed=args.seed, engine=args.engine, serving=serving,
                obs=_obs_config(args))
            _emit_json(report, args.out)
    wall = time.perf_counter() - t0
    _emit_serving_note(report)
    _emit_obs_note(report)
    _emit_incidents_note(report)
    print(f"[{report['scenario']['name']}] ({wall:.1f}s wall, "
          f"{_engine_of(args)} engine on {device})", file=sys.stderr)
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


# ----------------------------------------------------------------- inspect
def inspect_main(argv=None) -> int:
    """Time-travel inspection of a durable run: restore the newest snapshot
    at or before --tick, replay to exactly that tick, and print a
    deterministic state summary (byte-identical to a from-start replay and
    across tick engines).  ``--around-incident K`` jumps to the tick where
    incident K opened instead.  The replay runs on the run's own engine,
    on --device.
    """
    from repro_torch import resolve_device
    from repro_torch.durability import dump_inspection, inspect_run
    from repro_torch.durability.inspect import _fmt_table

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch inspect",
        description=inspect_main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("rundir", help="durable run directory (--durable output)")
    ap.add_argument("--tick", type=int, default=None,
                    help="tick to pause at (completed ticks)")
    ap.add_argument("--around-incident", type=int, default=None,
                    metavar="ID",
                    help="inspect at the tick incident ID opened")
    ap.add_argument("--from-start", action="store_true",
                    help="replay from tick 0 instead of the newest "
                         "snapshot (same bytes, slower — the CI check)")
    ap.add_argument("--device", default=None,
                    help="torch device for the replay's predictor and torch "
                         "tick engine (default: the CUDA card; 'cpu' runs "
                         "the plain path)")
    ap.add_argument("--out", default=None,
                    help="write the summary JSON here (default: stdout)")
    args = ap.parse_args(argv)
    if args.tick is None and args.around_incident is None:
        ap.error("need --tick or --around-incident")
    device = resolve_device(args.device)
    try:
        doc = inspect_run(args.rundir, args.tick,
                          around_incident=args.around_incident,
                          from_start=args.from_start, device=device)
    except (FileNotFoundError, ValueError) as exc:
        print(f"inspect: {exc}", file=sys.stderr)
        return 2
    text = dump_inspection(doc, args.out)
    if args.out:
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text, end="")
    print(_fmt_table(doc), file=sys.stderr)
    return 0


# -------------------------------------------------------------------- diff
def diff_main(argv=None) -> int:
    """WAL diff between two durable runs: bisect the per-segment sha256
    chains to the first mismatched segment, then report the exact first
    divergent event with surrounding context and each run's incident
    timeline at the divergence tick.  Exit 0 when the event streams are
    identical, 3 when they diverge.  Reads files only: no device.
    """
    from repro_torch.durability import diff_runs, format_diff
    from repro_torch.obs.export import canonical_json

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch diff", description=diff_main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("rundir_a", help="baseline durable run directory")
    ap.add_argument("rundir_b", help="comparison durable run directory")
    ap.add_argument("--context", type=int, default=3,
                    help="events of context around the divergence "
                         "(default: 3)")
    ap.add_argument("--out", default=None,
                    help="write the diff JSON here (default: stdout)")
    args = ap.parse_args(argv)
    try:
        doc = diff_runs(args.rundir_a, args.rundir_b, context=args.context)
    except (FileNotFoundError, ValueError) as exc:
        print(f"diff: {exc}", file=sys.stderr)
        return 2
    text = canonical_json(doc) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text, end="")
    print(format_diff(doc), file=sys.stderr)
    return 0 if doc["identical"] else 3


# ------------------------------------------------------------------- chaos
def chaos_main(argv=None) -> int:
    """Chaos verification: run a chaos-enabled scenario (baseline, durable
    chaos run, and a simulated SIGKILL + resume), then assert the
    survivability invariants — zero WAL event loss, every injected fault
    paired with a typed recovery, bounded-retry accounting, recovery
    byte-identity, snapshot skip-to-next-good, and SLO attainment within
    --slo-budget of the no-chaos baseline.  Prints the verdict JSON and
    exits nonzero when any invariant fails.
    """
    import tempfile

    from repro_torch import resolve_device
    from repro_torch.chaos.harness import run_chaos_verification

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch chaos", description=chaos_main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default="chaos-storm",
                    help="chaos-enabled scenario (default: chaos-storm)")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--hours", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    _add_device_flags(ap)
    ap.add_argument("--workdir", default=None,
                    help="where the durable run directories go (default: "
                         "a fresh temp directory)")
    ap.add_argument("--store", default="jsonl", choices=("jsonl", "sqlite"),
                    help="WAL backend for the durable runs")
    ap.add_argument("--slo-budget", type=float, default=0.25,
                    help="max allowed SLO-attainment drop vs the no-chaos "
                         "baseline (default: 0.25 — the storm's 2.5x "
                         "overload burst sheds by design, and shed counts "
                         "as missed)")
    ap.add_argument("--snapshot-every", type=float, default=900.0,
                    metavar="SECONDS",
                    help="snapshot cadence in sim seconds (default: 900)")
    ap.add_argument("--no-crash", dest="crash", action="store_false",
                    help="skip the SIGKILL + resume leg (faster)")
    ap.add_argument("--out", default=None,
                    help="write the verdict JSON here (default: stdout)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro-chaos-")
    try:
        doc = run_chaos_verification(
            args.scenario, workdir=workdir, seed=args.seed,
            engine=args.engine, devices=args.devices, hours=args.hours,
            backend=args.store, slo_budget=args.slo_budget,
            crash=args.crash, snapshot_every_s=args.snapshot_every,
            device=device)
    except (KeyError, ValueError) as exc:
        print(f"chaos: {exc}", file=sys.stderr)
        return 2
    _emit_json(doc, args.out)
    for inv in doc["invariants"]:
        mark = "PASS" if inv["ok"] else "FAIL"
        print(f"[chaos] {mark} {inv['name']}: {inv['detail']}",
              file=sys.stderr)
    wall = time.perf_counter() - t0
    res = doc["resilience"]
    print(f"[chaos] {doc['scenario']} seed={doc['seed']} "
          f"store={doc['backend']}: {res['injected']} faults injected, "
          f"{res['recovered']} recovered — "
          + ("all invariants hold" if doc["ok"] else "INVARIANTS VIOLATED")
          + f" ({wall:.1f}s wall, {args.engine} engine on {device})",
          file=sys.stderr)
    return 0 if doc["ok"] else 1


# ----------------------------------------------------------------- helpers
def _add_obs_flags(ap) -> None:
    g = ap.add_argument_group(
        "observability (artifacts are byte-identical across same-seed "
        "runs and across tick engines; see README 'Observability')")
    g.add_argument("--metrics-out", default=None, metavar="METRICS.jsonl",
                   help="write windowed fleet-metrics JSONL here")
    g.add_argument("--trace-out", default=None, metavar="TRACE.jsonl",
                   help="write job/request/fault trace JSONL here")
    g.add_argument("--prom-out", default=None, metavar="METRICS.prom",
                   help="write a Prometheus text-format snapshot here")
    g.add_argument("--metrics-every", type=float, default=600.0,
                   metavar="SECONDS",
                   help="metrics rollup window in sim seconds "
                        "(default: 600)")
    g.add_argument("--profile-phases", action="store_true",
                   help="wall-clock engine phase profile to stderr "
                        "(quarantined: never enters artifacts)")
    g.add_argument("--alerts-out", default=None, metavar="INCIDENTS.jsonl",
                   help="evaluate the alert-rule catalog at every metrics "
                        "window boundary and write the alert/incident "
                        "lifecycle JSONL here")
    g.add_argument("--alert-rules", default=None, metavar="RULE[,RULE...]",
                   help="comma-separated rule subset (default: the full "
                        "catalog; see --list-alert-rules)")
    g.add_argument("--list-alert-rules", action="store_true",
                   help="list the registered alert rules and exit")


def _list_alert_rules() -> int:
    from repro_torch.obs import default_alert_rules
    for r in default_alert_rules():
        gate = (f"> {r.threshold:g}"
                + (f" & slow{r.slow_windows}-mean > {r.slow_threshold:g}"
                   if r.kind == "burn_rate" and r.slow_threshold is not None
                   else ""))
        print(f"{r.name:22s} {r.severity:6s} {r.scope:8s} "
              f"{r.signal} {gate} for={r.for_windows} "
              f"clear={r.clear_windows}\n{'':22s} {r.description}")
    return 0


def _obs_config(args):
    if not (args.metrics_out or args.trace_out or args.prom_out
            or args.profile_phases or args.alerts_out):
        return None
    from repro_torch.obs import ObsConfig
    rules = tuple(r for r in (args.alert_rules or "").split(",") if r)
    return ObsConfig(metrics_out=args.metrics_out,
                     trace_out=args.trace_out, prom_out=args.prom_out,
                     metrics_every_s=args.metrics_every,
                     profile_phases=args.profile_phases,
                     alerts_out=args.alerts_out, alert_rules=rules)


def _emit_obs_note(report: dict) -> None:
    obs = report.get("obs")
    if not obs:
        return
    m, tr = obs.get("metrics"), obs.get("trace")
    if m:
        print(f"[obs] metrics: {m['rows']} rows, {m['windows']} windows, "
              f"{m['series']} series, digest {m['digest'][:12]}",
              file=sys.stderr)
    if tr:
        kinds = ", ".join(f"{k}={v}" for k, v in tr["kinds"].items())
        print(f"[obs] trace: {tr['rows']} rows ({kinds}), "
              f"digest {tr['digest'][:12]}", file=sys.stderr)


def _emit_incidents_note(report: dict) -> None:
    inc = report.get("incidents")
    if not inc:
        return
    print(f"[alerts] {inc['windows']} windows evaluated, "
          f"{inc['transitions']} transitions, {inc['total']} incidents "
          f"({inc['open_end']} open at end), digest {inc['digest'][:12]}",
          file=sys.stderr)


def _add_durability_flags(ap) -> None:
    g = ap.add_argument_group(
        "durability (write-ahead event log + snapshots; a resumed run's "
        "report is byte-identical to an uninterrupted one — see README "
        "'Durability & recovery')")
    g.add_argument("--durable", default=None, metavar="RUNDIR",
                   help="run with a write-ahead event log, periodic "
                        "snapshots, and a signed manifest in RUNDIR")
    g.add_argument("--resume", default=None, metavar="RUNDIR",
                   help="resume a crashed durable run from its newest "
                        "verified snapshot, on --device")
    g.add_argument("--snapshot-every", type=float, default=1800.0,
                   metavar="SECONDS",
                   help="snapshot cadence in sim seconds (default: 1800)")
    g.add_argument("--store", default="jsonl", choices=("jsonl", "sqlite"),
                   help="event-log backend (default: jsonl)")
    g.add_argument("--verify-manifest", default=None,
                   metavar="MANIFEST.json",
                   help="verify a run manifest (signature + artifact "
                        "hashes + WAL chain) and exit")


def _engine_of(args) -> str:
    """The tick engine a run used: a resumed run keeps its own."""
    if not args.resume:
        return args.engine
    import os
    with open(os.path.join(args.resume, "run.json")) as f:
        return json.load(f)["engine"]


def _durable_run(sc, args, device) -> dict:
    from repro_torch.durability import run_durable
    run = run_durable(sc, args.durable, obs=_obs_config(args), out=args.out,
                      snapshot_every_s=args.snapshot_every,
                      backend=args.store, device=device)
    _emit_json(run.report, run.out)
    run.finalize_manifest()
    print(f"[durable] {run.rundir}: {run.store.count()} events, "
          f"{run.snapshots_taken} snapshots, manifest signed",
          file=sys.stderr)
    return run.report


def _durable_resume(rundir: str, device) -> dict | None:
    """Resume a durable run on ``device``; a broken run directory prints an
    actionable message (never a traceback) and returns None — callers exit
    2."""
    import pickle

    from repro_torch.durability import resume_run
    try:
        run = resume_run(rundir, device=device)
    except FileNotFoundError as exc:
        print(f"resume: {exc}\nresume: pass the directory given to "
              "--durable (it must contain run.json)", file=sys.stderr)
        return None
    except (ValueError, EOFError, pickle.UnpicklingError, OSError) as exc:
        print(f"resume: {exc}\nresume: the run directory is damaged beyond "
              "what snapshot fallback can absorb — re-run with --durable "
              "to start over, or restore the directory from backup",
              file=sys.stderr)
        return None
    for rel, reason in run.snapshot_skips:
        print(f"[durable] skipped corrupt snapshot {rel}: {reason}",
              file=sys.stderr)
    _emit_json(run.report, run.out)
    run.finalize_manifest()
    origin = ("tick 0 (no usable snapshot)"
              if run.resumed_from_tick is None
              else f"tick {run.resumed_from_tick}")
    print(f"[durable] resumed {run.rundir} from {origin}: "
          f"{run.store.count()} events, manifest signed", file=sys.stderr)
    return run.report


def _verify_manifest_file(path: str) -> int:
    import os

    from repro_torch.durability import verify_rundir
    from repro_torch.durability.manifest import KEY_ENV
    problems = verify_rundir(path)
    for p in problems:
        print(f"MANIFEST: {p}", file=sys.stderr)
        if "HMAC signature mismatch" in p and not os.environ.get(KEY_ENV):
            print(f"MANIFEST: note: {KEY_ENV} is not set, so the documented "
                  "development key was used — if this run was signed with a "
                  f"production key, export {KEY_ENV} and re-verify",
                  file=sys.stderr)
    print("manifest " + ("FAIL" if problems else "OK"), file=sys.stderr)
    return 1 if problems else 0


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


def deprecation_note(old: str, new: str) -> None:
    """The legacy entry points' stderr-only notice — stdout bytes stay
    identical to the new CLI's, so artifact pipelines are unaffected."""
    print(f"note: `{old}` is deprecated; use `{new}` "
          f"(same flags, same output bytes)", file=sys.stderr)


# ---------------------------------------------------------------- dispatch
COMMANDS = {
    "sim": sim_main,
    "serve": serve_main,
    "profile": profile_main,
    "inspect": inspect_main,
    "diff": diff_main,
    "chaos": chaos_main,
}


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
