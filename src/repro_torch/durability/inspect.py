"""Time-travel inspection: the live state of a durable run at any tick.

``inspect_run`` answers "what did the cluster look like at tick T?" for a
finished (or crashed) durable run: pick the newest manifest-verified
snapshot at or before T, restore a fresh ControlPlane from it, replay the
remaining ticks to *exactly* T via :meth:`ControlPlane.run`'s pause seam
(``stop_tick``), and summarize the paused state — device/mstate histograms,
the job queue and placement table, serving lane depths, and the incident
timeline open at T (read back from the run's persisted ``incidents.jsonl``).

Determinism contract: the summary document is byte-identical whether the
replay started from a snapshot or from tick 0 (``from_start=True``), and
across the numpy/torch engines — CI cmp-gates this.  The inspection plane is
read-only: it never attaches a WAL sink, never truncates the store, and
runs with ``obs=None`` so the run's own metrics/trace/alert artifacts are
untouched.

Copied from `repro/durability/inspect.py`; the port adds ``device=`` (where
the replay's predictor trains and its torch tick engine runs: the CUDA card
unless ``"cpu"``).
"""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from repro_torch.durability.manifest import file_sha256
from repro_torch.durability.snapshot import restore_control
from repro_torch.obs.alerts import incidents_open_at, read_incidents
from repro_torch.obs.export import canonical_json

INSPECT_SCHEMA = "repro.durability.inspect/v1"

_MSTATE_NAMES = ("init", "healthy", "unhealthy", "overlimit", "disabled")


def _pick_snapshot_before(run, tick: int):
    """Newest manifest-verified snapshot with ``tick_i <= tick`` (snapshot
    filenames carry the tick, so mismatching ones are skipped without
    unpickling)."""
    listed = getattr(run, "_manifest", {}).get("artifacts", {})
    paths = sorted(glob.glob(
        os.path.join(run.rundir, "snapshots", "snap-*.pkl")), reverse=True)
    for path in paths:
        base = os.path.basename(path)
        try:
            snap_tick = int(base[len("snap-"):-len(".pkl")])
        except ValueError:
            continue
        if snap_tick > tick:
            continue
        rel = os.path.relpath(path, run.rundir)
        entry = listed.get(rel)
        if entry is None:
            continue
        sha, size = file_sha256(path)
        if sha != entry["sha256"] or size != entry["bytes"]:
            continue
        with open(path, "rb") as f:
            return pickle.load(f)
    return None


def build_paused(run, tick: int, *, from_start: bool = False,
                 predictor=None, device=None):
    """A fresh ControlPlane for ``run``'s scenario, advanced to exactly
    ``tick`` completed ticks and paused (not finalized).  Returns
    ``(cp, replayed_from_tick)``."""
    from repro_torch.cluster.control import ControlPlane
    sc = run.scenario
    n_ticks = int(sc.horizon_seconds() / sc.tick_s)
    if not 0 <= tick <= n_ticks:
        raise ValueError(f"tick {tick} outside the run's horizon "
                         f"[0, {n_ticks}]")
    cp = ControlPlane(sc, predictor=predictor, obs=None, device=device)
    start_tick, start_t = 0, 0.0
    snap = None if from_start else _pick_snapshot_before(run, tick)
    if snap is not None:
        restore_control(cp, snap, store=run.store)
        start_tick, start_t = snap["tick_i"], snap["t"]
    cp.run(start_tick=start_tick, start_t=start_t, stop_tick=tick)
    return cp, start_tick


def summarize_state(cp, tick: int) -> dict:
    """The deterministic state document for a paused ControlPlane.  Every
    field derives from engine-identical state — never paths, snapshot
    provenance, or wall clock — so snapshot-replay and from-start paths
    produce identical bytes."""
    sim = cp.sim
    sc = cp.scenario
    t = tick * sc.tick_s
    s = sim.state
    n = int(sim.cfg.n_devices)
    failed = s.failed_until > t
    outage = s.outage_until > t
    mstate_hist = np.bincount(sim.monitor.state,
                              minlength=len(_MSTATE_NAMES))
    by_model: dict[str, int] = {}
    by_pool: dict[str, int] = {}
    for i in np.flatnonzero(s.has_job):
        spec = sim.job_spec[int(i)]
        if spec is not None:
            by_model[spec.model] = by_model.get(spec.model, 0) + 1
        pool = sim.pool_names[int(sim.pool_of[int(i)])]
        by_pool[pool] = by_pool.get(pool, 0) + 1
    serving = None
    if cp.serving is not None:
        serving = {
            lane.service: {
                "queued": int(sum(c[1] for c in lane.queue)),
                "arrived": int(lane.arrived),
                "served": int(lane.served),
                "shed": int(lane.shed),
                "peak_queue": int(lane.peak_queue),
            } for lane in cp.serving.lanes}
    return {
        "schema": INSPECT_SCHEMA,
        "scenario": sc.name,
        "seed": sc.seed,
        "policy": sc.policy,
        "tick": tick,
        "t": t,
        "devices": {
            "total": n,
            "failed": int(failed.sum()),
            "outage": int(outage.sum()),
            "busy": int(s.has_job.sum()),
            "schedulable": int(sim.monitor.schedulable.sum()),
        },
        "mstate": {name: int(mstate_hist[i])
                   for i, name in enumerate(_MSTATE_NAMES)},
        "pools": sim.pool_view(t),
        "jobs": {
            "pending": len(sim.pending),
            "running": int(s.has_job.sum()),
            "finished": len(sim.finished),
            "executions": int(sim.executions),
            "evictions": int(sim.evictions),
            "errors_injected": int(sim.errors_injected),
            "online_incidents": int(sim.online_incidents),
            "trace_submitted": int(cp._trace_i),
            "next_pending": [spec.job_id for spec in sim.pending[:10]],
        },
        "placements": {
            "by_model": dict(sorted(by_model.items())),
            "by_pool": dict(sorted(by_pool.items())),
        },
        "serving": serving,
        "events": {
            "n_events": int(cp.bus.n_events),
            "counts": {k: int(v)
                       for k, v in sorted(cp.bus.counts.items())},
        },
    }


def _run_incidents(run):
    """The run's persisted incident timeline, if it recorded one."""
    path = run.obs.alerts_out if run.obs is not None else None
    if path and os.path.exists(path):
        return read_incidents(path)
    return None


def inspect_run(rundir: str, tick: int | None = None, *,
                around_incident: int | None = None,
                from_start: bool = False, predictor=None,
                device=None) -> dict:
    """Time-travel a durable run to a tick and summarize its state (see
    module docstring).  ``around_incident=K`` targets the tick incident K
    opened at instead of an explicit ``tick``.  ``device`` places the
    replay's card work (None: the CUDA card)."""
    from repro_torch.cluster.control import jsonify
    from repro_torch.durability.runner import DurableRun
    run = DurableRun.open(rundir)
    try:
        incidents = _run_incidents(run)
        if around_incident is not None:
            if incidents is None:
                raise ValueError(
                    f"--around-incident needs an incidents.jsonl, but "
                    f"{rundir} recorded none (run with --alerts-out)")
            inc = next((i for i in incidents if i.id == around_incident),
                       None)
            if inc is None:
                raise ValueError(
                    f"no incident id {around_incident} in {rundir} "
                    f"({len(incidents)} incidents recorded)")
            tick = int(round(inc.opened_t / run.scenario.tick_s))
        if tick is None:
            raise ValueError("need a tick or an incident id to inspect at")
        cp, _ = build_paused(run, tick, from_start=from_start,
                             predictor=predictor, device=device)
        doc = summarize_state(cp, tick)
        if incidents is not None:
            t = tick * run.scenario.tick_s
            doc["incidents"] = {
                "total": len(incidents),
                "open_at_t": [inc.row()
                              for inc in incidents_open_at(incidents, t)],
            }
        else:
            doc["incidents"] = None
        return jsonify(doc)
    finally:
        run.store.close()


def dump_inspection(doc: dict, path: str | None = None) -> str:
    """Serialize an inspection document with the canonical exporter (sorted
    keys, rounded floats) — the byte-stable form CI ``cmp``s.  Writes to
    ``path`` when given; returns the serialized text either way."""
    text = canonical_json(doc) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def _fmt_table(doc: dict) -> str:
    """A short human-readable digest (stderr; never cmp-gated)."""
    dev = doc["devices"]
    jobs = doc["jobs"]
    lines = [
        f"tick {doc['tick']} (t={doc['t']:.0f}s) scenario="
        f"{doc['scenario']} seed={doc['seed']}",
        f"devices: {dev['total']} total, {dev['busy']} busy, "
        f"{dev['schedulable']} schedulable, {dev['failed']} failed, "
        f"{dev['outage']} in outage",
        f"jobs: {jobs['running']} running, {jobs['pending']} pending, "
        f"{jobs['finished']} finished ({jobs['evictions']} evictions, "
        f"{jobs['errors_injected']} errors, "
        f"{jobs['online_incidents']} online incidents)",
    ]
    inc = doc.get("incidents")
    if inc is not None:
        open_rows = inc["open_at_t"]
        lines.append(f"incidents: {inc['total']} total, "
                     f"{len(open_rows)} open at t"
                     + ("".join(f"\n  #{r['id']} {r['rule']} [{r['target']}]"
                                f" {r['severity']} opened t={r['opened_t']}"
                                for r in open_rows[:10])))
    return "\n".join(lines)
