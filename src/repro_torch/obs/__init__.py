"""Deterministic observability: metrics, traces, phase profiling, exporters.

See the submodule docstrings for the contracts; the short version:

* every artifact (metrics JSONL, trace JSONL, Prometheus text) is
  byte-identical across same-seed runs, across processes, and across the
  numpy/torch tick engines — sim time only, canonical JSON, sorted keys;
* emission streams per window/row, so fleet-scale runs stay O(window) in
  memory;
* wall-clock phase profiling is quarantined to stderr + BENCH_sim.json,
  and the serve and train steps' spans (`repro_torch.obs.spans`) to the
  in-memory log of whoever attaches one;
* alerting (`repro_torch.obs.alerts`) evaluates a deterministic rule catalog at
  metrics-window boundaries — incidents.jsonl inherits the byte-identity
  contract.

Copied from `repro/obs`; under one predictor every artifact is byte-equal
to `repro`'s.  The schema strings are `repro`'s, verbatim: they name the
artifacts, not the package.
"""
from repro_torch.obs.alerts import (ALERT_RULES, ALERTS_SCHEMA, Alert,
                                    AlertEngine, AlertRule, Incident,
                                    alert_rules_available, default_alert_rules,
                                    incidents_open_at, read_incidents,
                                    register_alert_rule, resolve_alert_rules)
from repro_torch.obs.export import (JsonlWriter, canonical_json,
                                    lint_prometheus, prometheus_text)
from repro_torch.obs.metrics import (METRICS_SCHEMA, FleetMetricsRecorder,
                                     MetricsRegistry)
from repro_torch.obs.phases import PHASES, PhaseProfiler
from repro_torch.obs.plane import OBS_SCHEMA, ObsConfig, ObsPlane
from repro_torch.obs.spans import Span, SpanLog, attach, detach, span
from repro_torch.obs.trace import (TRACE_SCHEMA, EventBusTracer, RequestTracer,
                                   TraceWriter)

__all__ = [
    "OBS_SCHEMA", "METRICS_SCHEMA", "TRACE_SCHEMA", "PHASES",
    "ALERTS_SCHEMA", "ALERT_RULES",
    "ObsConfig", "ObsPlane",
    "MetricsRegistry", "FleetMetricsRecorder",
    "Alert", "AlertEngine", "AlertRule", "Incident",
    "alert_rules_available", "default_alert_rules", "resolve_alert_rules",
    "register_alert_rule", "read_incidents", "incidents_open_at",
    "TraceWriter", "EventBusTracer", "RequestTracer",
    "PhaseProfiler",
    "Span", "SpanLog", "span", "attach", "detach",
    "JsonlWriter", "canonical_json", "prometheus_text", "lint_prometheus",
]
