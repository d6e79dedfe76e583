"""Capture/restore of the control plane's full mutable state.

A snapshot is taken at a tick boundary and records *only mutable state*:
everything static — fleet layout, QPS curves, feasibility masks, trained
predictor weights, trace schedules — is a deterministic function of the
Scenario and is rebuilt by constructing a fresh :class:`ControlPlane` on
resume.  That keeps snapshots small and sidesteps everything unpicklable
(torch predictor params, ``sim.tick_qps`` closures inside serving lanes,
open file handles).

Three things cannot be pickled at all and are *reconstructed* instead:

* the EventBus's running SHA-256 — replayed from the WAL prefix
  ``[0, n_events)`` (``Event.key()`` round-trips storage exactly);
* each obs ``JsonlWriter``'s running SHA-256 — the snapshot records the
  flushed byte offset, resume truncates the surviving partial file to it
  and re-hashes those bytes;
* numpy ``Generator`` streams — captured as ``bit_generator.state`` dicts.

Wall-clock-only state (``sim.schedule_latencies``, the phase profiler) is
deliberately dropped: it is quarantined from every deterministic artifact,
so resetting it cannot move report bytes.

Copied from `repro/durability/snapshot.py`; ``restore_sim`` drops the
port's lazily built torch engine (``sim._torch``) where `repro` drops its
xla one.
"""
from __future__ import annotations

import collections
import copy

import numpy as np

SNAPSHOT_SCHEMA = "repro.durability.snapshot/v1"


def _copy_arrays(d: dict) -> dict:
    return {k: (np.copy(v) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


# --------------------------------------------------------------------- sim
def capture_sim(sim) -> dict:
    """Mutable state of a :class:`~repro_torch.core.simulator.ClusterSim`."""
    s = sim.state
    snap = {
        "rng": sim.rng.bit_generator.state,
        "state": {k: np.copy(getattr(s, k)) for k in vars(s)},
        "monitor": {k: np.copy(getattr(sim.monitor, k))
                    for k in ("state", "_init_at", "_readmit_at",
                              "_ol_times", "_ol_ptr")},
        "job_spec": list(sim.job_spec),
        "pending": list(sim.pending),
        "finished": list(sim.finished),
        "evictions": sim.evictions,
        "executions": sim.executions,
        "errors_injected": sim.errors_injected,
        "online_incidents": sim.online_incidents,
        "_n_injected": sim._n_injected,
        "_lat_sum": sim._lat_sum,
        "_lat_wsum": sim._lat_wsum,
        "_base_lat_sum": sim._base_lat_sum,
        "_lat_hist": np.copy(sim._lat_hist),
        "_util_acc": np.copy(sim._util_acc),
        "_util_ticks": sim._util_ticks,
        "_tput_sum": sim._tput_sum,
        "_tput_ticks": sim._tput_ticks,
        "_timeline": {k: list(v) for k, v in sim._timeline.items()},
        "_job_i": sim._job_i,
        "_next_sched": sim._next_sched,
        "_ext_mask": (np.copy(sim._ext_mask)
                      if sim._ext_mask is not None else None),
        "err_handled": list(sim.err_handler.handled),
    }
    pred = sim.predictor
    if hasattr(pred, "_cache"):     # CachedSpeedPredictor wrapper
        snap["predictor"] = {
            "cache": collections.OrderedDict(pred._cache),
            "hits": pred.hits, "misses": pred.misses,
            "evictions": pred.evictions}
    if sim._matcher is not None:
        m = sim._matcher
        snap["matcher"] = {
            "cache": dict(m._cache), "n_shards": m._n_shards,
            "rounds": m.rounds, "shards_solved": m.shards_solved,
            "shards_reused": m.shards_reused,
            "full_solves": m.full_solves}
    return snap


def restore_sim(sim, snap: dict) -> None:
    """Overwrite a freshly-constructed sim's mutable state in place.  Pure
    caches (``_qps_memo``, the offline gather cache, the lazily-built torch
    engine) are reset, not restored — they rebuild deterministically.  The
    engine must go: it copies ``monitor._init_at`` to its device once, as
    static, and the monitor arrays were just replaced."""
    sim.rng.bit_generator.state = snap["rng"]
    for k, v in snap["state"].items():
        setattr(sim.state, k, np.copy(v))
    for k, v in snap["monitor"].items():
        setattr(sim.monitor, k, np.copy(v))
    sim.job_spec = list(snap["job_spec"])
    sim.pending = list(snap["pending"])
    sim.finished = list(snap["finished"])
    sim.evictions = snap["evictions"]
    sim.executions = snap["executions"]
    sim.errors_injected = snap["errors_injected"]
    sim.online_incidents = snap["online_incidents"]
    sim._n_injected = snap["_n_injected"]
    sim._lat_sum = snap["_lat_sum"]
    sim._lat_wsum = snap["_lat_wsum"]
    sim._base_lat_sum = snap["_base_lat_sum"]
    sim._lat_hist = np.copy(snap["_lat_hist"])
    sim._util_acc = np.copy(snap["_util_acc"])
    sim._util_ticks = snap["_util_ticks"]
    sim._tput_sum = snap["_tput_sum"]
    sim._tput_ticks = snap["_tput_ticks"]
    sim._timeline = {k: list(v) for k, v in snap["_timeline"].items()}
    sim._job_i = snap["_job_i"]
    sim._next_sched = snap["_next_sched"]
    sim._ext_mask = (np.copy(snap["_ext_mask"])
                     if snap["_ext_mask"] is not None else None)
    sim.err_handler.handled = list(snap["err_handled"])
    sim.schedule_latencies = []          # wall-clock-only; quarantined
    sim._qps_memo = None
    sim._off_cache = {}
    sim._off_cache_ver = -1
    sim._torch = None
    if "predictor" in snap:
        p = snap["predictor"]
        sim.predictor._cache = collections.OrderedDict(p["cache"])
        sim.predictor.hits = p["hits"]
        sim.predictor.misses = p["misses"]
        sim.predictor.evictions = p["evictions"]
    if "matcher" in snap and sim._matcher is not None:
        m = snap["matcher"]
        sim._matcher._cache = dict(m["cache"])
        sim._matcher._n_shards = m["n_shards"]
        sim._matcher.rounds = m["rounds"]
        sim._matcher.shards_solved = m["shards_solved"]
        sim._matcher.shards_reused = m["shards_reused"]
        sim._matcher.full_solves = m["full_solves"]


# ----------------------------------------------------------------- serving
def _capture_serving(plane) -> list[dict]:
    lanes = []
    for lane in plane.lanes:
        lanes.append({
            "service": lane.service,
            "queue": [list(c) for c in lane.queue],
            "hist": np.copy(lane.hist),
            "arrived": lane.arrived, "served": lane.served,
            "shed": lane.shed, "within_slo": lane.within_slo,
            "win_hist": np.copy(lane.win_hist),
            "win_arrived": lane.win_arrived, "win_served": lane.win_served,
            "win_shed": lane.win_shed, "win_within": lane.win_within,
            "lat_sum_ms": lane.lat_sum_ms, "max_ms": lane.max_ms,
            "peak_queue": lane.peak_queue, "cap_sum": lane.cap_sum,
            "ticks": lane.ticks, "batch_seq": lane._batch_seq,
            "brownout_shed": lane.brownout_shed,
            "size_rng": lane.size_rng.bit_generator.state,
            "stream": (lane.process._stream.bit_generator.state
                       if lane.process._stream is not None else None),
        })
    return lanes


def _restore_serving(plane, lanes: list[dict]) -> None:
    from collections import deque
    by_svc = {row["service"]: row for row in lanes}
    if set(by_svc) != {ln.service for ln in plane.lanes}:
        raise ValueError("snapshot serving lanes do not match scenario")
    for lane in plane.lanes:
        row = by_svc[lane.service]
        lane.queue = deque([list(c) for c in row["queue"]])
        lane.hist = np.copy(row["hist"])
        lane.arrived = row["arrived"]
        lane.served = row["served"]
        lane.shed = row["shed"]
        lane.within_slo = row["within_slo"]
        lane.win_hist = np.copy(row["win_hist"])
        lane.win_arrived = row["win_arrived"]
        lane.win_served = row["win_served"]
        lane.win_shed = row["win_shed"]
        lane.win_within = row["win_within"]
        lane.lat_sum_ms = row["lat_sum_ms"]
        lane.max_ms = row["max_ms"]
        lane.peak_queue = row["peak_queue"]
        lane.cap_sum = row["cap_sum"]
        lane.ticks = row["ticks"]
        lane._batch_seq = row["batch_seq"]
        lane.brownout_shed = row.get("brownout_shed", 0)
        lane.size_rng.bit_generator.state = row["size_rng"]
        if row["stream"] is not None:
            lane.process._stream.bit_generator.state = row["stream"]


# --------------------------------------------------------------------- obs
def _capture_registry(registry) -> dict:
    fams = {}
    for name, fam in registry._families.items():
        children = {}
        for key, child in fam._children.items():
            if fam.kind == "histogram":
                children[key] = ("h", list(child.bucket_counts),
                                 child.sum, child.count)
            else:
                children[key] = (fam.kind[0], child.value)
        fams[name] = children
    return fams


def _restore_registry(registry, fams: dict) -> None:
    from repro_torch.obs.metrics import _Counter, _Gauge, _Histogram
    for name, children in fams.items():
        fam = registry._families[name]
        fam._children.clear()
        for key, payload in children.items():
            if payload[0] == "h":
                child = _Histogram(fam.buckets)
                child.bucket_counts = list(payload[1])
                child.sum = payload[2]
                child.count = payload[3]
            elif payload[0] == "c":
                child = _Counter()
                child.value = payload[1]
            else:
                child = _Gauge()
                child.value = payload[1]
            fam._children[key] = child


def _capture_writer(writer) -> dict:
    """Flush, then record the file's durable byte offset + row count; the
    running sha256 is rebuilt from those bytes on resume."""
    import os
    writer._flush()
    offset = None
    if writer._f is not None:
        writer._f.flush()
        offset = os.fstat(writer._f.fileno()).st_size
    return {"rows": writer.rows, "offset": offset}


def restore_writer(writer, rows: int, prefix: bytes) -> None:
    """Reset a freshly-constructed writer to a mid-stream position: the
    surviving file prefix becomes the file content, the running sha256 is
    re-derived from it, and the fresh constructor's buffered header (the
    same bytes, already inside ``prefix``) is discarded."""
    import hashlib
    writer._buf.clear()
    writer.rows = rows
    writer._hash = hashlib.sha256(prefix)
    if writer._f is not None:
        writer._f.seek(0)
        writer._f.truncate()
        writer._f.write(prefix.decode("utf-8"))
        writer._f.flush()


def _capture_obs(obs) -> dict:
    snap: dict = {"metrics": None, "trace": None, "alerts": None}
    if obs.metrics is not None:
        rec = obs.metrics
        snap["metrics"] = {
            "writer": _capture_writer(rec.writer),
            "dev_acc": np.copy(rec._dev_acc),
            "prev_healthy": np.copy(rec._prev_healthy),
            "tick_i": rec._tick_i, "win_ticks": rec._win_ticks,
            "windows": rec.windows,
            "prev_totals": dict(rec._prev_totals),
            "registry": _capture_registry(rec.registry)}
    if getattr(obs, "alerts", None) is not None:
        eng = obs.alerts
        snap["alerts"] = {
            "writer": _capture_writer(eng.writer),
            "windows": eng.windows,
            "breach_windows": eng.breach_windows,
            "transitions": eng.transitions,
            "next_id": eng._next_id,
            "incidents": [dict(vars(i)) for i in eng.incidents],
            "states": {key: {"state": st.state, "breaches": st.breaches,
                             "clears": st.clears, "peak": st.peak,
                             "ring": list(st.ring),
                             "incident": (st.incident.id
                                          if st.incident is not None
                                          else None)}
                       for key, st in eng._states.items()}}
    if obs.trace is not None:
        bt = obs._bus_tracer
        snap["trace"] = {
            "writer": _capture_writer(obs.trace.writer),
            "kinds": dict(obs.trace.kinds),
            "submit": dict(bt._submit),
            "open": {j: dict(v) for j, v in bt._open.items()},
            "segments": dict(bt._segments)}
    return snap


def _restore_obs(obs, snap: dict, prefixes: dict) -> None:
    """``prefixes`` maps ``"metrics"``/``"trace"`` to the surviving file
    prefix bytes (read *before* fresh construction truncated the files)."""
    if snap["metrics"] is not None:
        rec = obs.metrics
        m = snap["metrics"]
        restore_writer(rec.writer, m["writer"]["rows"],
                       prefixes.get("metrics", b""))
        rec._dev_acc = np.copy(m["dev_acc"])
        rec._prev_healthy = np.copy(m["prev_healthy"])
        rec._tick_i = m["tick_i"]
        rec._win_ticks = m["win_ticks"]
        rec.windows = m["windows"]
        rec._prev_totals = dict(m["prev_totals"])
        _restore_registry(rec.registry, m["registry"])
    if snap.get("alerts") is not None and obs.alerts is not None:
        from repro_torch.obs.alerts import Incident, _RuleState
        al = snap["alerts"]
        eng = obs.alerts
        restore_writer(eng.writer, al["writer"]["rows"],
                       prefixes.get("alerts", b""))
        eng.windows = al["windows"]
        eng.breach_windows = al["breach_windows"]
        eng.transitions = al["transitions"]
        eng._next_id = al["next_id"]
        eng.incidents = [Incident(**row) for row in al["incidents"]]
        by_id = {i.id: i for i in eng.incidents}
        eng._states = {}
        for key, row in al["states"].items():
            st = _RuleState()
            st.state = row["state"]
            st.breaches = row["breaches"]
            st.clears = row["clears"]
            st.peak = row["peak"]
            st.ring = list(row["ring"])
            st.incident = (by_id[row["incident"]]
                           if row["incident"] is not None else None)
            eng._states[key] = st
    if snap["trace"] is not None:
        tr = snap["trace"]
        restore_writer(obs.trace.writer, tr["writer"]["rows"],
                       prefixes.get("trace", b""))
        obs.trace.kinds = dict(tr["kinds"])
        bt = obs._bus_tracer
        bt._submit = dict(tr["submit"])
        bt._open = {j: dict(v) for j, v in tr["open"].items()}
        bt._segments = dict(tr["segments"])


# ----------------------------------------------------------- control plane
def capture_control(cp, t: float, tick_i: int) -> dict:
    """Snapshot a mid-run :class:`~repro_torch.cluster.control.ControlPlane` at a
    tick boundary (after tick ``tick_i`` completed, sim clock at ``t``)."""
    bus = cp.bus
    snap = {
        "schema": SNAPSHOT_SCHEMA,
        "t": t,
        "tick_i": tick_i,
        "bus": {"n_events": bus.n_events,
                "counts": dict(bus.counts),
                "sink_events": bus.sink_events},
        "sim": capture_sim(cp.sim),
        "trace_i": cp._trace_i,
        "last_telemetry": _copy_arrays(cp.last_telemetry),
        "autoscale_decisions": [dict(d) for d in cp.autoscale_decisions],
        "scalers": {svc: {"replicas": s.replicas,
                          "last_scale_at": s._last_scale_at,
                          "below_since": s._below_since}
                    for svc, s in cp.scalers.items()},
        "campaign": None, "agents": None, "jobs": None,
        "serving": None, "obs": None, "chaos": None,
    }
    if cp.campaign is not None:
        c = cp.campaign
        snap["campaign"] = {"rng": c.rng.bit_generator.state,
                            "injected": dict(c.injected_by_kind),
                            "propagated": dict(c.propagated_by_kind)}
    if cp.agents is not None:
        a = cp.agents
        snap["agents"] = {
            "rng": a.rng.bit_generator.state,
            "last_report": np.copy(a.last_report),
            "stale": np.copy(a.stale),
            "stale_episodes": a.stale_episodes,
            "stale_device_ticks": a.stale_device_ticks,
            "reports_sent": a.reports_sent,
            "reports_dropped": a.reports_dropped,
            "next_beat": a._next_beat,
            "seen": _copy_arrays(a.seen),
            "seen_state": np.copy(a.seen_state)}
    if cp.job_manager is not None:
        jm = cp.job_manager
        # JobRecords are mutable — copy so post-snapshot ticks can't bleed in
        snap["jobs"] = {"jobs": {j: copy.copy(r)
                                 for j, r in jm.jobs.items()},
                        "violations": list(jm.violations)}
    if cp.serving is not None:
        snap["serving"] = _capture_serving(cp.serving)
    if getattr(cp, "chaos", None) is not None:
        snap["chaos"] = cp.chaos.capture()
    if cp.obs is not None:
        snap["obs"] = _capture_obs(cp.obs)
    return snap


def restore_control(cp, snap: dict, *, store=None,
                    obs_prefixes: dict | None = None) -> None:
    """Overwrite a freshly-constructed ControlPlane's mutable state from a
    snapshot.  ``store`` (the WAL) replays the event prefix to rebuild the
    bus's running sha256; ``obs_prefixes`` carries the surviving obs file
    prefixes (read before construction truncated them)."""
    bus = cp.bus
    n = snap["bus"]["n_events"]
    bus._seq = n
    bus.counts = dict(snap["bus"]["counts"])
    bus.sink_events = snap["bus"]["sink_events"]
    if store is not None:
        bus._hash = store.replay_digest(n)
        if bus.keep_log:
            # reproduce emit()'s retention semantics over the prefix
            bus.log = []
            bus.dropped = 0
            for ev in store.read(0, n):
                if len(bus.log) < bus.log_cap:
                    bus.log.append(ev)
                else:
                    bus.dropped += 1
    restore_sim(cp.sim, snap["sim"])
    cp._trace_i = snap["trace_i"]
    cp.last_telemetry = _copy_arrays(snap["last_telemetry"])
    cp.autoscale_decisions = [dict(d) for d in snap["autoscale_decisions"]]
    for svc, row in snap["scalers"].items():
        s = cp.scalers[svc]
        s.replicas = row["replicas"]
        s._last_scale_at = row["last_scale_at"]
        s._below_since = row["below_since"]
    if snap["campaign"] is not None:
        c = cp.campaign
        c.rng.bit_generator.state = snap["campaign"]["rng"]
        c.injected_by_kind = dict(snap["campaign"]["injected"])
        c.propagated_by_kind = dict(snap["campaign"]["propagated"])
    if snap["agents"] is not None:
        a = cp.agents
        row = snap["agents"]
        a.rng.bit_generator.state = row["rng"]
        a.last_report = np.copy(row["last_report"])
        a.stale = np.copy(row["stale"])
        a.stale_episodes = row["stale_episodes"]
        a.stale_device_ticks = row["stale_device_ticks"]
        a.reports_sent = row["reports_sent"]
        a.reports_dropped = row["reports_dropped"]
        a._next_beat = row["next_beat"]
        a.seen = _copy_arrays(row["seen"])
        a.seen_state = np.copy(row["seen_state"])
    if snap["jobs"] is not None and cp.job_manager is not None:
        cp.job_manager.jobs = {j: copy.copy(r)
                               for j, r in snap["jobs"]["jobs"].items()}
        cp.job_manager.violations = list(snap["jobs"]["violations"])
    if snap["serving"] is not None and cp.serving is not None:
        _restore_serving(cp.serving, snap["serving"])
    if (snap.get("chaos") is not None
            and getattr(cp, "chaos", None) is not None):
        cp.chaos.restore(snap["chaos"])
    if snap["obs"] is not None and cp.obs is not None:
        _restore_obs(cp.obs, snap["obs"], obs_prefixes or {})
