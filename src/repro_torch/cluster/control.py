"""The ControlPlane: owns the tick loop and wires every §5 deployment piece.

Layering (control plane ⇄ sim core)::

    Scenario ──► ControlPlane ──────────────────────────────┐
                   │  per tick, in order:                   │
                   │   1. submit due jobs  (JobManager)     │
                   │   2. inject faults    (FaultCampaign)  │
                   │   3. agent heartbeats (NodeAgentFleet) │──► EventBus
                   │   4. autoscale online pools            │     │
                   │   5. ClusterSim.step(t)  ◄─ SimHooks ──┘     ▼
                   │        (vectorized engine tick)         JSON report
                   └─► ClusterSim.finalize(t)

The engine stays a pure vectorized core; everything event-shaped lives up
here.  With all control-plane features neutral (no campaign, no heartbeat
drops, trace-driven jobs) the trajectory is identical to ``ClusterSim.run``
— that passthrough is what lets the figure benchmarks ride the same entry
point without renumbering.

Copied from `repro/cluster/control.py`; under one predictor both packages
give byte-equal reports.  What the port adds is ``device=`` (where the
predictor trains, the torch tick engine runs and a measured policy builds
its matrix: the CUDA card unless ``"cpu"``), kept out of the scenario like
``obs`` so that the scenario echo is the same on every machine.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.chaos import CHAOS_SCHEMA, ChaosCampaign
from repro_torch.cluster.agents import NodeAgentFleet
from repro_torch.cluster.events import EventBus, EventKind
from repro_torch.cluster.faults import FaultCampaign
from repro_torch.cluster.fleet import FleetSpec
from repro_torch.cluster.jobs import JobManager
from repro_torch.cluster.scenario import Scenario, scenario_by_name
from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.core.interference import ONLINE_SERVICE_PROFILES
from repro_torch.core.simulator import (ClusterSim, SimConfig, SimHooks,
                                        build_sim_config)
from repro_torch.core.traces import SERVICES, make_trace
from repro_torch.obs import ALERTS_SCHEMA, OBS_SCHEMA, ObsPlane
from repro_torch.policies import resolve as resolve_policy
from repro_torch.serving_plane import SERVING_SCHEMA, ServingPlane

# v5: adds the top-level "resilience" section (chaos plane: injected
# infrastructure faults, the degradation-ladder engagements that answered
# them, fault↔recovery pairing; null when no chaos campaign ran).
# v4 added the "incidents" section (alert engine: rule catalog,
# incident lifecycle counts, stream digest; null when alerting is off).
# v3 added the "obs" section (observability plane: emitted-series counts
# and stream digests) and the events summary's "log_dropped" count.
# v2 added the "serving" section (request-level serving plane).
REPORT_SCHEMA = "repro.cluster.report/v5"

SCHEMA_KEYS = ("schema", "scenario", "sim", "jobs", "faults", "agents",
               "autoscaler", "serving", "pools", "scheduler", "events",
               "obs", "incidents", "resilience")

_SERVING_SVC_KEYS = ("arrived", "served", "shed", "p50_ms", "p99_ms",
                     "slo_ms", "slo_attainment")


def check_schema(report: dict) -> list[str]:
    """Structural lint of a campaign report; returns a list of problems
    (empty = OK).  Used by the CLI's ``--check-schema`` and CI."""
    problems = []
    if report.get("schema") != REPORT_SCHEMA:
        problems.append(f"schema != {REPORT_SCHEMA!r}: "
                        f"{report.get('schema')!r}")
    for k in SCHEMA_KEYS:
        if k not in report:
            problems.append(f"missing top-level key {k!r}")
    serving = report.get("serving")
    if serving is not None:
        if serving.get("schema") != SERVING_SCHEMA:
            problems.append(f"serving.schema != {SERVING_SCHEMA!r}: "
                            f"{serving.get('schema')!r}")
        for req in ("services", "total"):
            if req not in serving:
                problems.append(f"missing serving key {req!r}")
        for svc, row in sorted(serving.get("services", {}).items()):
            for k in _SERVING_SVC_KEYS:
                if k not in row:
                    problems.append(f"serving service {svc!r} missing {k!r}")
    obs = report.get("obs")
    if obs is not None:
        if obs.get("schema") != OBS_SCHEMA:
            problems.append(f"obs.schema != {OBS_SCHEMA!r}: "
                            f"{obs.get('schema')!r}")
        for req in ("metrics", "trace", "profile_phases"):
            if req not in obs:
                problems.append(f"missing obs key {req!r}")
        for section in ("metrics", "trace"):
            row = obs.get(section)
            if row is not None:
                for k in ("rows", "digest"):
                    if k not in row:
                        problems.append(f"obs.{section} missing {k!r}")
    incidents = report.get("incidents")
    if incidents is not None:
        if incidents.get("schema") != ALERTS_SCHEMA:
            problems.append(f"incidents.schema != {ALERTS_SCHEMA!r}: "
                            f"{incidents.get('schema')!r}")
        for req in ("rows", "digest", "rules", "windows", "total",
                    "open_end", "timeline"):
            if req not in incidents:
                problems.append(f"missing incidents key {req!r}")
    resilience = report.get("resilience")
    if resilience is not None:
        if resilience.get("schema") != CHAOS_SCHEMA:
            problems.append(f"resilience.schema != {CHAOS_SCHEMA!r}: "
                            f"{resilience.get('schema')!r}")
        for req in ("injected", "recovered", "unmatched",
                    "unmatched_by_kind", "open_end", "injected_by_kind",
                    "recovered_by_kind", "ladder"):
            if req not in resilience:
                problems.append(f"missing resilience key {req!r}")
    events = report.get("events")
    if isinstance(events, dict):
        for k in ("log_dropped", "sink_events", "sink_dropped"):
            if k not in events:
                problems.append(f"events summary missing {k!r}")
    return problems


class _HookAdapter(SimHooks):
    """Translates engine hook callbacks into bus events."""

    def __init__(self, cp: "ControlPlane"):
        self.cp = cp

    def on_job_start(self, sim, t, device, spec, share):
        self.cp.bus.emit(t, EventKind.JOB_START, device=device,
                         job=spec.job_id,
                         data=(("model", spec.model),
                               ("share", round(share, 4))))

    def on_job_finish(self, sim, t, device, spec, jct_s, wall_s, progress_s):
        self.cp.bus.emit(t, EventKind.JOB_FINISH, device=device,
                         job=spec.job_id,
                         data=(("jct_s", round(jct_s, 3)),
                               ("wall_s", round(wall_s, 3))))

    def on_job_evict(self, sim, t, device, spec, reason, progress_s,
                     checkpoint_s, requeued):
        self.cp.bus.emit(t, EventKind.JOB_EVICT, device=device,
                         job=spec.job_id,
                         data=(("reason", reason),
                               ("progress_s", round(progress_s, 3)),
                               ("checkpoint_s", round(checkpoint_s, 3)),
                               ("requeued", requeued)))

    def on_error(self, sim, t, device, handled):
        self.cp.bus.emit(t, EventKind.ERROR, device=device,
                         data=(("kind", handled.kind.value),
                               ("action", handled.action.value),
                               ("propagated", handled.propagated)))

    def on_device_fail(self, sim, t, device, until):
        self.cp.bus.emit(t, EventKind.DEVICE_FAIL, device=device,
                         data=(("until", round(until, 3)),))

    def on_schedule(self, sim, t, n_free, n_pending_before, n_assigned,
                    wall_s):
        # wall_s deliberately excluded: events must be bit-reproducible
        self.cp.bus.emit(t, EventKind.SCHEDULE,
                         data=(("free", n_free),
                               ("pending", n_pending_before),
                               ("assigned", n_assigned)))

    def on_tick_end(self, sim, t, telemetry):
        self.cp.last_telemetry = telemetry


class ControlPlane:
    """Discrete-event control plane over the vectorized engine."""

    def __init__(self, scenario: Scenario, predictor=None, obs=None,
                 device=None):
        sc = scenario
        self.scenario = sc
        self.bus = EventBus(keep_log=sc.keep_event_log)
        self.fleet = FleetSpec(sc.n_devices, sc.pools) if sc.pools else None
        pol = resolve_policy(sc.policy).on_device(device)
        if predictor is None and pol.needs_predictor:
            # the policy owns predictor construction (SharingPolicy.
            # build_predictor): synthetic-model training by default,
            # measured-pair training for calibrated policies
            gpu_types = (self.fleet.gpu_types if self.fleet
                         else tuple(dict.fromkeys(sc.gpu_types)))
            predictor = pol.build_predictor(
                gpu_types, samples=sc.predictor_samples,
                epochs=sc.predictor_epochs, seed=0, device=device)
        cfg = SimConfig(
            policy=pol, n_devices=sc.n_devices,
            horizon_s=sc.horizon_seconds(), tick_s=sc.tick_s,
            schedule_interval_s=sc.schedule_interval_s,
            checkpoint_interval_s=sc.checkpoint_interval_s,
            restart_delay_s=sc.restart_delay_s, trace=sc.trace,
            seed=sc.seed, gpu_types=tuple(sc.gpu_types),
            graceful_exit=sc.graceful_exit,
            error_rate_per_job_hour=sc.error_rate_per_job_hour,
            device_mtbf_h=sc.device_mtbf_h,
            device_repair_s=sc.device_repair_s,
            online_outage_s=sc.online_outage_s,
            memory_quota=sc.memory_quota, shard_size=sc.shard_size,
            predictor_cache_quantum=sc.predictor_cache_quantum,
            engine=sc.engine, device=device,
            incremental_matching=sc.incremental_matching)
        self.sim = ClusterSim(cfg, predictor, fleet=self.fleet,
                              hooks=_HookAdapter(self),
                              external_jobs=sc.external_jobs)
        # lifecycle tracking needs control-plane-submitted jobs (the engine's
        # internal trace mode never emits JOB_SUBMIT)
        self.job_manager = (JobManager(self.bus,
                                       restart_delay_s=cfg.restart_delay_s,
                                       strict=sc.strict_lifecycle)
                            if sc.external_jobs else None)
        # trace generated up here when jobs are control-plane-submitted;
        # same generator/seed the engine itself would use, so a scenario is
        # comparable against a plain ClusterSim run of the same config
        self.trace_jobs = (make_trace(sc.trace, sc.n_devices,
                                      cfg.horizon_s, sc.seed)
                           if sc.external_jobs else [])
        self._trace_i = 0
        # derived, decoupled seeds: campaign/agent randomness never touches
        # the engine's trace/failure RNG stream
        self.campaign = (FaultCampaign(sc.faults, self.sim,
                                       seed=sc.seed * 7919 + 1)
                         if sc.faults is not None else None)
        self.agents = (NodeAgentFleet(sc.n_devices, sc.agents,
                                      seed=sc.seed * 104729 + 2,
                                      bus=self.bus)
                       if sc.agents is not None else None)
        self.scalers: dict[str, Autoscaler] = {}
        self.autoscale_decisions: list[dict] = []
        if sc.autoscale:
            for si, svc in enumerate(SERVICES):
                n_svc = int((self.sim.service_idx == si).sum())
                if n_svc == 0:
                    continue
                self.scalers[svc] = Autoscaler(
                    AutoscalerConfig(min_replicas=max(1, n_svc // 4),
                                     max_replicas=n_svc),
                    replicas=max(1, int(n_svc * 0.6)),
                    qps_capacity_per_replica=(
                        ONLINE_SERVICE_PROFILES[svc]["qps_capacity"]))
        # request-level serving plane: lane seeds derive from the scenario
        # seed through a third decoupled stream (campaign and agents take
        # the first two) so request arrivals never perturb — and are never
        # perturbed by — the engine/campaign/agent RNG streams
        self.serving = None
        if sc.serving is not None:
            self.serving = ServingPlane.from_sim(
                self.sim, sc.serving, seed=sc.seed * 52361 + 3)
            self.sim.attach_serving(self.serving)
        # chaos plane: a fourth decoupled seed stream.  The campaign IS the
        # FaultInjector every seam consults — agents, serving lanes, the
        # scheduler round (via sim.chaos), and the durable event store
        # (wired by the durability runner).  None = every seam skips its
        # consult and the trajectory is byte-identical to pre-chaos builds.
        self.chaos = None
        if sc.chaos is not None:
            self.chaos = ChaosCampaign(sc.chaos, self.sim,
                                       seed=sc.seed * 15485863 + 4,
                                       bus=self.bus)
            self.chaos.serving = self.serving
            self.sim.chaos = self.chaos
            if self.agents is not None:
                self.agents.fault_injector = self.chaos
            if self.serving is not None:
                self.serving.fault_injector = self.chaos
        # observability plane: an ObsConfig, deliberately NOT a Scenario
        # field — output paths are machine-local and the scenario echo in
        # the report must stay byte-identical across machines.  Enabling
        # obs never changes the report outside its own "obs" section.
        self.obs = None
        if obs is not None and obs.enabled:
            self.obs = ObsPlane(obs, self.sim, bus=self.bus,
                                serving=self.serving)
        self.last_telemetry: dict = {}
        self.results = None
        self._t_end = 0.0

    # ------------------------------------------------------------------ run
    def run(self, *, start_tick: int = 0, start_t: float = 0.0,
            stop_tick: int | None = None, tick_callback=None):
        """Drive the scenario from ``start_tick`` (0 = a fresh run; the
        durability plane resumes from a snapshot's tick boundary with the
        snapshot's recorded ``start_t``); returns the engine's SimResults
        (the JSON report comes from :meth:`report`).

        ``stop_tick`` pauses the loop after that many completed ticks
        *without* finalizing (time-travel inspection peeks at the exact
        live state a running campaign had at that tick boundary); the
        return value is ``None`` for a paused run.

        ``tick_callback(ticks_done, t)`` fires after each completed tick —
        the durable runner's snapshot/WAL-flush seam.  It must not touch
        sim state (the tick trajectory has to be byte-identical with and
        without a callback attached)."""
        sc = self.scenario
        sim = self.sim
        t = start_t
        n_ticks = int(sc.horizon_seconds() / sc.tick_s)
        if stop_tick is not None:
            n_ticks = min(stop_tick, n_ticks)
        for i in range(start_tick, n_ticks):
            self._submit_due(t)
            if self.campaign is not None:
                self.campaign.inject(t, sc.tick_s)
            if self.chaos is not None:
                self.chaos.inject(t, sc.tick_s)
            if self.agents is not None:
                fresh = self.agents.observe(sim, t, self.last_telemetry)
                sim.set_schedulable_mask(fresh)
            if self.scalers:
                self._autoscale(t)
            t = sim.step(t)
            if tick_callback is not None:
                tick_callback(i + 1, t)
        self._t_end = t
        if stop_tick is not None:
            return None
        self.results = sim.finalize(t)
        if self.obs is not None:
            self.obs.finalize(t)
        return self.results

    def _submit_due(self, t: float) -> None:
        due = []
        while (self._trace_i < len(self.trace_jobs)
               and self.trace_jobs[self._trace_i].submit_s <= t):
            spec = self.trace_jobs[self._trace_i]
            self._trace_i += 1
            due.append(spec)
            self.bus.emit(t, EventKind.JOB_SUBMIT, job=spec.job_id,
                          data=(("model", spec.model),
                                ("duration_s", round(spec.duration_s, 3))))
        if due:
            self.sim.inject_jobs(due)

    def _autoscale(self, t: float) -> None:
        sim = self.sim
        qps = sim.tick_qps(t)       # memoized: the engine reads the same row
        for si, svc in enumerate(SERVICES):
            scaler = self.scalers.get(svc)
            if scaler is None:
                continue
            mask = sim.service_idx == si
            dec = scaler.observe(float(qps[mask].sum()), t)
            if dec is None:
                continue
            self.bus.emit(t, EventKind.AUTOSCALE,
                          data=(("service", svc),
                                ("replicas", dec.replicas),
                                ("delta", dec.delta),
                                ("reason", dec.reason)))
            self.autoscale_decisions.append(
                {"t": t, "service": svc, "replicas": dec.replicas,
                 "delta": dec.delta, "reason": dec.reason})
            if dec.delta > 0:
                # scale-up: online capacity wins — evict the offline
                # partners on this service's devices to free them
                busy = np.flatnonzero(mask & sim.state.has_job)
                for i in busy[:dec.delta]:
                    sim.evict_device(int(i), t, reason="autoscale")

    # --------------------------------------------------------------- report
    def report(self) -> dict:
        """Deterministic JSON-ready campaign report (no wall-clock fields)."""
        if self.results is None:
            raise RuntimeError("run() the scenario before report()")
        sc = self.scenario
        rep = {
            "schema": REPORT_SCHEMA,
            "scenario": sc.to_dict(),
            "sim": dataclasses.asdict(self.results),
            "jobs": (self.job_manager.summary()
                     if self.job_manager is not None else None),
            "faults": (self.campaign.summary()
                       if self.campaign is not None else None),
            "agents": (self.agents.summary()
                       if self.agents is not None else None),
            "autoscaler": ({"n_decisions": len(self.autoscale_decisions),
                            "decisions": self.autoscale_decisions,
                            "replicas": {svc: s.replicas for svc, s in
                                         sorted(self.scalers.items())}}
                           if self.scalers else None),
            "serving": (self.serving.summary()
                        if self.serving is not None else None),
            "pools": self.sim.pool_view(self._t_end),
            "scheduler": self._scheduler_telemetry(),
            "events": self.bus.summary(),
            "obs": (self.obs.summary()
                    if self.obs is not None else None),
            "incidents": (self.obs.incidents_summary()
                          if self.obs is not None else None),
            "resilience": (self.chaos.summary()
                           if self.chaos is not None else None),
        }
        return jsonify(rep)

    def _scheduler_telemetry(self) -> dict:
        """Deterministic scheduler-side counters: speed-predictor memo
        hit/miss/eviction stats and incremental-matcher shard reuse.  Both
        are pure functions of the (seeded) call sequence, so they are
        byte-identical across tick engines like the rest of the report."""
        sim = self.sim
        pred = sim.predictor
        return {
            "predictor_cache": (pred.stats()
                                if hasattr(pred, "stats") else None),
            "matching": (sim._matcher.stats()
                         if sim._matcher is not None else None),
        }


def jsonify(obj):
    """Recursively convert numpy scalars/arrays so json.dumps round-trips."""
    if isinstance(obj, dict):
        return {k: jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [jsonify(v) for v in obj.tolist()]
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def run_scenario(name_or_scenario, predictor=None, obs=None, device=None,
                 **overrides) -> dict:
    """Build, run, and report a scenario in one call.

    ``name_or_scenario`` is a registry name or a :class:`Scenario`;
    ``overrides`` replace scenario fields (None values are ignored);
    ``obs`` is an optional :class:`repro_torch.obs.ObsConfig` (metrics/
    trace/Prometheus outputs and phase profiling — never a scenario field);
    ``device`` places the card work (None: the CUDA card)."""
    sc = (scenario_by_name(name_or_scenario)
          if isinstance(name_or_scenario, str) else name_or_scenario)
    sc = sc.with_overrides(**overrides)
    cp = ControlPlane(sc, predictor=predictor, obs=obs, device=device)
    cp.run()
    return cp.report()


def run_policy_scenario(policy, predictor=None, device=None,
                        **sim_overrides):
    """Neutral passthrough for the figure benchmarks: run one policy through
    the control plane with every scenario feature off — the trajectory is
    identical to ``repro_torch.core.simulator.run_policy`` (same engine, same RNG
    stream, trace-driven jobs, no campaign/agent/autoscale interference) but
    rides the ControlPlane entry point and yields its event stream.

    Policy resolution goes through the same ``build_sim_config`` path as
    ``run_policy`` itself, so name validation cannot drift between the two.
    One deliberate difference remains: for a ``needs_predictor`` policy with
    ``predictor=None``, ``run_policy`` raises while this entry point (like
    every scenario run) auto-builds a default predictor — pass the predictor
    explicitly when comparing trajectories against ``run_policy``."""
    cfg, pol = build_sim_config(policy, **sim_overrides)
    # every SimConfig knob maps onto a Scenario field (the device onto the
    # ControlPlane's own argument) — nothing the caller
    # passes can be silently dropped on the way into the ControlPlane
    sc = Scenario(
        name=f"policy:{pol.name}", policy=cfg.policy, n_devices=cfg.n_devices,
        hours=cfg.horizon_s / 3600.0, horizon_s=cfg.horizon_s,
        tick_s=cfg.tick_s,
        schedule_interval_s=cfg.schedule_interval_s,
        checkpoint_interval_s=cfg.checkpoint_interval_s,
        restart_delay_s=cfg.restart_delay_s, trace=cfg.trace,
        seed=cfg.seed, gpu_types=tuple(cfg.gpu_types),
        graceful_exit=cfg.graceful_exit,
        error_rate_per_job_hour=cfg.error_rate_per_job_hour,
        device_mtbf_h=cfg.device_mtbf_h,
        device_repair_s=cfg.device_repair_s,
        online_outage_s=cfg.online_outage_s, memory_quota=cfg.memory_quota,
        shard_size=cfg.shard_size,
        predictor_cache_quantum=cfg.predictor_cache_quantum,
        pools=(), faults=None, agents=None, autoscale=False,
        external_jobs=False, engine=cfg.engine,
        incremental_matching=cfg.incremental_matching)
    cp = ControlPlane(sc, predictor=predictor, device=device)
    return cp.run()
