"""The chaos verification harness: run a chaos scenario, prove survival.

``run_chaos_verification`` executes one chaos-enabled scenario three ways
and checks the survivability invariants the chaos plane promises:

1. a **baseline** run with chaos stripped (``chaos=None``) — the SLO
   yardstick;
2. a **durable chaos** run (WAL + snapshots) — checked for zero event
   loss (WAL count and replay digest match the bus), complete
   fault↔recovery pairing, bounded-retry accounting, and online SLO
   attainment within ``slo_budget`` of the baseline;
3. a **crash** run — the same durable run killed mid-campaign via a
   simulated SIGKILL (``store.abandon()``, a torn WAL tail, and the
   newest snapshot garbled in a hash-consistent way), then resumed.
   The resumed report must be byte-identical to the uninterrupted
   run's, and resume must have exercised skip-to-next-good.

Every check lands in a ``repro.chaos.verify/v1`` verdict document; the
``python -m repro_torch chaos`` CLI prints it and exits nonzero when any
invariant fails.  The harness is deterministic end to end — no
wall-clock reads, no unseeded randomness.

Copied from `repro/chaos/harness.py`; the port adds ``device=`` (where the
predictor trains and the torch tick engine runs: the CUDA card unless
``"cpu"``), and ``engine`` takes ``numpy`` or ``torch``.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

VERIFY_SCHEMA = "repro.chaos.verify/v1"

# Longest chaos episode (predictor outage, 900 s) plus slack: injection
# stops this long before the horizon so every episode closes and every
# fault pairs with a recovery before finalize.
_QUIET_TAIL_S = 1200.0

_GARBAGE_PICKLE = b"\x80\x05 this is not a snapshot pickle"
_TORN_LINE = '{"seq": 99999999, "t": 1.0, "kin'


class _SimulatedKill(BaseException):
    """Raised from a tick callback to model SIGKILL mid-campaign; derives
    from BaseException so production ``except Exception`` paths cannot
    swallow it (neither would a real SIGKILL)."""


def _invariant(name: str, ok: bool, detail: str) -> dict:
    return {"name": name, "ok": bool(ok), "detail": detail}


def _resolve(scenario, *, seed, engine, devices, hours):
    from repro_torch.cluster.scenario import scenario_by_name
    sc = (scenario_by_name(scenario) if isinstance(scenario, str)
          else scenario)
    sc = sc.with_overrides(seed=seed, engine=engine, n_devices=devices,
                           hours=hours)
    if sc.chaos is None:
        raise ValueError(f"scenario {sc.name!r} has no chaos config — "
                         "nothing to verify (try chaos-storm)")
    horizon = sc.horizon_seconds()
    end_s = min(sc.chaos.end_s, max(0.0, horizon - _QUIET_TAIL_S))
    return dataclasses.replace(
        sc, chaos=dataclasses.replace(sc.chaos, end_s=end_s))


def _zero_event_loss(store, ev: dict) -> tuple[bool, str]:
    n_store = store.count()
    n_bus = ev["n_events"]
    if n_store != n_bus:
        return False, f"WAL holds {n_store} events, bus emitted {n_bus}"
    if ev["sink_dropped"]:
        return False, f"bus dropped {ev['sink_dropped']} sink events"
    digest = store.replay_digest(n_store).hexdigest()
    if digest != ev["digest"]:
        return False, "WAL replay digest != bus digest"
    return True, f"{n_store} events, replay digest matches"


def _crash_partway(run, predictor=None, device=None) -> int:
    """Drive a fresh DurableRun exactly like ``execute()``'s fresh branch,
    but die (simulated SIGKILL) partway through the third snapshot
    interval — after two snapshots exist, before the run finishes."""
    from repro_torch.cluster.control import ControlPlane
    every, n_ticks = run._every_ticks(), run._n_ticks()
    crash_tick = min(n_ticks - 1, 2 * every + every // 2)
    run.store.truncate(0)
    run.cp = ControlPlane(run.scenario, predictor=predictor, obs=run.obs,
                          device=device)
    run.store.fault_injector = getattr(run.cp, "chaos", None)
    run.cp.bus.attach_sink(run.store.append)
    inner = run._tick_callback()

    def cb(ticks_done: int, t: float) -> None:
        inner(ticks_done, t)
        if ticks_done >= crash_tick:
            raise _SimulatedKill()

    try:
        run.cp.run(tick_callback=cb)
    except _SimulatedKill:
        pass
    return crash_tick


def _tear_wal_tail(rundir: str, backend: str) -> str:
    """Leave the WAL the way a SIGKILL would: the jsonl backend gets a
    torn half-line appended to its live segment; the sqlite backend's
    uncommitted suffix is already gone (``abandon()`` rolled it back)."""
    if backend != "jsonl":
        return "sqlite: uncommitted suffix rolled back by abandon()"
    segs = sorted(glob.glob(
        os.path.join(rundir, "events", "segment-*.jsonl")))
    if not segs:
        return "no segment to tear"
    with open(segs[-1], "a") as f:
        f.write(_TORN_LINE)
    return f"torn half-line appended to {os.path.basename(segs[-1])}"


def _garble_newest_snapshot(rundir: str) -> str | None:
    """Overwrite the newest snapshot with garbage bytes and re-sign the
    manifest so the hash still verifies — the snapshot is only discovered
    to be corrupt at unpickle time, exercising skip-to-next-good (not the
    cheaper hash-mismatch path).  Returns the garbled relpath, or None if
    fewer than two snapshots exist (nothing older to fall back to)."""
    from repro_torch.durability.manifest import (file_sha256, sign_manifest,
                                                 write_manifest)
    snaps = sorted(glob.glob(
        os.path.join(rundir, "snapshots", "snap-*.pkl")))
    if len(snaps) < 2:
        return None
    target = snaps[-1]
    with open(target, "wb") as f:
        f.write(_GARBAGE_PICKLE)
    manifest_path = os.path.join(rundir, "manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    rel = os.path.relpath(target, rundir)
    sha, size = file_sha256(target)
    manifest["artifacts"][rel] = {"sha256": sha, "bytes": size}
    body = {k: v for k, v in manifest.items() if k != "signature"}
    manifest["signature"] = sign_manifest(body)
    write_manifest(manifest_path, manifest)
    return rel


def run_chaos_verification(scenario="chaos-storm", *, workdir: str,
                           seed: int | None = None,
                           engine: str | None = None,
                           devices: int | None = None,
                           hours: float | None = None,
                           backend: str = "jsonl",
                           slo_budget: float = 0.25,
                           crash: bool = True,
                           snapshot_every_s: float = 900.0,
                           predictor=None, device=None) -> dict:
    """Run the chaos campaign and verify the survivability invariants.
    Returns the ``repro.chaos.verify/v1`` verdict document.

    ``slo_budget`` bounds how far attainment may fall below the no-chaos
    baseline.  It proves *bounded* degradation, not zero impact: the
    storm's overload burst multiplies demand 2.5x for its whole window
    and every brownout-shed request counts as an SLO miss, so the
    correct ladder response (shed rather than collapse) itself costs
    attainment roughly in proportion to the excess demand.  The default
    absorbs the full-size chaos-storm burst; tighten it for scenarios
    without ``serving_burst``.  ``device`` places the card work (None: the
    CUDA card)."""
    from repro_torch.cluster.control import run_scenario
    from repro_torch.durability.runner import (DurableRun, resume_run,
                                               run_durable)

    sc = _resolve(scenario, seed=seed, engine=engine, devices=devices,
                  hours=hours)
    inv: list[dict] = []

    # ---- baseline: same scenario, chaos stripped ------------------------
    base_rep = run_scenario(dataclasses.replace(sc, chaos=None),
                            predictor=predictor, device=device)

    # ---- durable chaos run ---------------------------------------------
    rundir_a = os.path.join(workdir, "chaos-durable")
    run_a = run_durable(sc, rundir_a, backend=backend,
                        snapshot_every_s=snapshot_every_s,
                        predictor=predictor, device=device)
    rep_a = run_a.report
    res = rep_a["resilience"]

    inv.append(_invariant(
        "faults-injected", res["injected"] > 0,
        f"{res['injected']} faults injected: {res['injected_by_kind']}"))
    inv.append(_invariant(
        "fault-recovery-pairing",
        res["unmatched"] == 0 and res["open_end"] == 0,
        f"unmatched={res['unmatched']} ({res['unmatched_by_kind']}), "
        f"open at end={res['open_end']}"))
    ok, detail = _zero_event_loss(run_a.store, rep_a["events"])
    inv.append(_invariant("zero-event-loss", ok, detail))
    lad = res["ladder"]
    inv.append(_invariant(
        "store-retry-ladder",
        lad["store_faults"] == 0
        or lad["store_retries"] >= lad["store_faults"],
        f"{lad['store_faults']} injected WAL faults, "
        f"{lad['store_retries']} bounded retries"))
    base_att = chaos_att = None
    if rep_a["serving"] is not None and base_rep["serving"] is not None:
        base_att = base_rep["serving"]["total"]["slo_attainment"]
        chaos_att = rep_a["serving"]["total"]["slo_attainment"]
        inv.append(_invariant(
            "slo-degradation-budget", chaos_att >= base_att - slo_budget,
            f"attainment {chaos_att:.4f} under chaos vs {base_att:.4f} "
            f"baseline (budget {slo_budget:.4f})"))
    run_a.store.close()

    # ---- crash + resume -------------------------------------------------
    if crash:
        rundir_b = os.path.join(workdir, "chaos-crash")
        run_b = DurableRun.create(sc, rundir_b, backend=backend,
                                  snapshot_every_s=snapshot_every_s)
        crash_tick = _crash_partway(run_b, predictor=predictor,
                                    device=device)
        run_b.store.abandon()
        tear = _tear_wal_tail(rundir_b, backend)
        garbled = _garble_newest_snapshot(rundir_b)
        run_b2 = resume_run(rundir_b, predictor=predictor, device=device)
        identical = (json.dumps(run_b2.report, sort_keys=True)
                     == json.dumps(rep_a, sort_keys=True))
        inv.append(_invariant(
            "recovery-byte-identity", identical,
            f"killed at tick {crash_tick} ({tear}); resumed from tick "
            f"{run_b2.resumed_from_tick}; report "
            + ("byte-identical to the uninterrupted run"
               if identical else "DIVERGED from the uninterrupted run")))
        if garbled is not None:
            inv.append(_invariant(
                "snapshot-skip-to-next-good",
                len(run_b2.snapshot_skips) >= 1,
                f"garbled {garbled} (hash-consistent); skips recorded: "
                f"{run_b2.snapshot_skips}"))
        run_b2.store.close()

    return {
        "schema": VERIFY_SCHEMA,
        "scenario": sc.name,
        "seed": sc.seed,
        "engine": sc.engine,
        "backend": backend,
        "ok": all(i["ok"] for i in inv),
        "invariants": inv,
        "resilience": res,
        "slo": {"baseline_attainment": base_att,
                "chaos_attainment": chaos_att,
                "budget": slo_budget},
    }
