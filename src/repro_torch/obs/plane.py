"""The observability plane: config + orchestrator behind one seam.

:class:`ObsConfig` is what callers (the CLI's ``--metrics-out`` /
``--trace-out`` / ``--prom-out`` / ``--metrics-every`` / ``--profile-phases``
/ ``--alerts-out`` flags, or ``run_scenario(obs=...)``) hand to the control
plane.  It is
deliberately **not** a Scenario field: output paths are machine-local and the
scenario echo in the report must stay byte-identical across machines —
enabling observability never changes the report outside its own ``obs``
section (a test pins this neutrality).

:class:`ObsPlane` wires the pieces to a built sim/bus/serving-plane:

* metrics  → :class:`FleetMetricsRecorder` on the sim's obs seam
  (``ClusterSim.attach_obs`` → called at the end of ``_account``);
* alerts   → :class:`AlertEngine` fed by the recorder at every window
  boundary (rules over the same accumulators; ``incidents.jsonl``);
* traces   → :class:`EventBusTracer` subscribed to the bus and a
  :class:`RequestTracer` attached to the serving lanes;
* phases   → :class:`PhaseProfiler` on the sim's phase seam (wall clock,
  quarantined: stderr + BENCH_sim.json only).

All seams are ``None`` checks in the engine — zero cost when disabled.

Copied from `repro/obs/plane.py`; ``ObsConfig`` keeps `repro`'s fields
exactly, since a durable run writes them into ``run.json``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys

from repro_torch.obs.alerts import AlertEngine, resolve_alert_rules
from repro_torch.obs.export import JsonlWriter, prometheus_text
from repro_torch.obs.metrics import FleetMetricsRecorder
from repro_torch.obs.phases import PhaseProfiler
from repro_torch.obs.trace import EventBusTracer, RequestTracer, TraceWriter

OBS_SCHEMA = "repro.obs/v1"


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What to record and where.  All outputs default off."""
    metrics_out: str | None = None      # windowed fleet metrics JSONL
    trace_out: str | None = None        # job/request/fault trace JSONL
    prom_out: str | None = None         # Prometheus text snapshot
    metrics_every_s: float = 600.0      # rollup window (sim seconds)
    profile_phases: bool = False        # wall-clock tick-phase profile
    alerts_out: str | None = None       # alert/incident lifecycle JSONL
    alert_rules: tuple = ()             # rule-name subset ((): full catalog)

    @property
    def enabled(self) -> bool:
        return bool(self.metrics_out or self.trace_out or self.prom_out
                    or self.profile_phases or self.alerts_out)


class ObsPlane:
    """One scenario run's observability surfaces (see module doc)."""

    def __init__(self, cfg: ObsConfig, sim, *, bus=None, serving=None):
        self.cfg = cfg
        self.metrics: FleetMetricsRecorder | None = None
        self.trace: TraceWriter | None = None
        self.phases: PhaseProfiler | None = None
        self._bus_tracer: EventBusTracer | None = None
        self._prom_digest: str | None = None
        self.alerts: AlertEngine | None = None
        if cfg.metrics_out or cfg.prom_out or cfg.alerts_out:
            # prom-only / alerts-only still run the recorder (digest-only
            # JSONL sink): the snapshot needs the registry, alerting needs
            # the window accumulators, and the report records what the
            # JSONL stream would have been
            self.metrics = FleetMetricsRecorder(
                sim, JsonlWriter(cfg.metrics_out),
                every_s=cfg.metrics_every_s, serving=serving)
            sim.attach_obs(self)
            if cfg.alerts_out:
                rules = (resolve_alert_rules(cfg.alert_rules)
                         if cfg.alert_rules else None)
                self.alerts = AlertEngine(
                    JsonlWriter(cfg.alerts_out), rules,
                    window_s=self.metrics.window_s)
                self.metrics.alerts = self.alerts
        if cfg.trace_out:
            self.trace = TraceWriter(JsonlWriter(cfg.trace_out))
            self._bus_tracer = EventBusTracer(self.trace)
            if bus is not None:
                self._bus_tracer.install(bus)
            if serving is not None:
                serving.attach_tracer(RequestTracer(self.trace))
        if cfg.profile_phases:
            self.phases = PhaseProfiler()
            sim.attach_phases(self.phases)

    # ------------------------------------------------------------- per-tick
    def on_tick(self, sim, inp: dict, core: dict) -> None:
        self.metrics.on_tick(sim, inp, core)

    # ------------------------------------------------------------ lifecycle
    def finalize(self, t_end: float) -> None:
        """Flush partial windows and open spans, write the Prometheus
        snapshot, close files, print the (quarantined) phase table."""
        if self.metrics is not None:
            self.metrics.finalize(t_end)
            if self.alerts is not None:
                self.alerts.finalize(t_end)
                self.alerts.writer.close()
            if self.cfg.prom_out:
                text = prometheus_text(self.metrics.registry)
                with open(self.cfg.prom_out, "w") as f:
                    f.write(text)
                self._prom_digest = hashlib.sha256(
                    text.encode()).hexdigest()
            self.metrics.writer.close()
        if self._bus_tracer is not None:
            self._bus_tracer.finalize(t_end)
            self.trace.close()
        if self.phases is not None:
            print(self.phases.format_table(), file=sys.stderr)

    def summary(self) -> dict:
        """The report's ``obs`` section: stream digests and row counts —
        deterministic identifiers of what was emitted, never paths or
        wall-clock values."""
        metrics = None
        if self.metrics is not None:
            metrics = self.metrics.summary()
            metrics["prom_digest"] = self._prom_digest
        return {"schema": OBS_SCHEMA,
                "metrics": metrics,
                "trace": (self.trace.summary()
                          if self.trace is not None else None),
                "profile_phases": bool(self.phases is not None)}

    def incidents_summary(self) -> dict | None:
        """The report's top-level ``"incidents"`` section (``None`` when
        alerting is off — the section key is always present in report/v4)."""
        return self.alerts.summary() if self.alerts is not None else None
