"""repro_torch.api — the curated public surface.

One import target for examples, notebooks, and downstream tooling, so they
stop deep-importing private module paths (which this project treats as free
to move between PRs).  Everything exported here is covered by tests and
kept stable; anything not exported is an implementation detail.

Groups:

* **Policies** — :class:`SharingPolicy`, ``register`` / ``resolve`` /
  ``available`` (the string-keyed sharing-policy registry);
* **Engine** — ``build_sim_config`` (validated :class:`SimConfig` +
  resolved policy), ``run_policy`` for bare engine runs, and the
  Algorithm-1 pieces (``schedule``, ``OnlineSlot``, ``OfflineJob``,
  ``dynamic_sm``, ``build_speed_predictor``, profile tables) the
  quickstart composes by hand;
* **Cluster** — the scenario registry (``Scenario``, ``SCENARIOS``,
  ``scenario_by_name``) and runners (``run_scenario`` → JSON report,
  ``run_policy_scenario`` → SimResults), plus ``check_schema`` /
  ``REPORT_SCHEMA``;
* **Serving** — :class:`ArrivalProcess` (the shared workload definition),
  :class:`ServingConfig` / :class:`ServingPlane`, and the admission-policy
  registry;
* **Observability** — :class:`ObsConfig` (pass as ``run_scenario(obs=...)``),
  :class:`MetricsRegistry` / :class:`PhaseProfiler` for standalone use, and
  the exporter helpers (``canonical_json``, ``prometheus_text``,
  ``lint_prometheus``);
* **Alerting** — the alert-rule registry (``AlertRule``,
  ``register_alert_rule`` / ``resolve_alert_rules`` /
  ``alert_rules_available`` / ``default_alert_rules``), the window-boundary
  :class:`AlertEngine` with its :class:`Incident` lifecycle, and the
  ``incidents.jsonl`` readers (``read_incidents``, ``incidents_open_at``);
* **Forensics** — ``inspect_run`` (time-travel a durable run to a tick and
  summarize its state) and ``diff_runs`` (pinpoint the first divergent WAL
  event between two runs via chain bisection).
"""
from __future__ import annotations

from repro_torch.cluster.control import (REPORT_SCHEMA, check_schema,
                                         run_scenario, run_policy_scenario)
from repro_torch.durability import (DIFF_SCHEMA, INSPECT_SCHEMA, diff_runs,
                                    inspect_run)
from repro_torch.obs import (ALERTS_SCHEMA, OBS_SCHEMA, AlertEngine, AlertRule,
                             Incident, MetricsRegistry, ObsConfig, ObsPlane,
                             PhaseProfiler, alert_rules_available,
                             canonical_json, default_alert_rules,
                             incidents_open_at, lint_prometheus,
                             prometheus_text, read_incidents,
                             register_alert_rule, resolve_alert_rules)
from repro_torch.cluster.scenario import SCENARIOS, Scenario, scenario_by_name
from repro_torch.core.dynamic_sm import dynamic_sm
from repro_torch.core.interference import (OFFLINE_MODEL_PROFILES,
                                           ONLINE_SERVICE_PROFILES,
                                           online_profile)
from repro_torch.core.predictor import build_speed_predictor
from repro_torch.core.scheduler import OfflineJob, OnlineSlot, schedule
from repro_torch.core.simulator import (SimConfig, SimResults,
                                        build_sim_config, run_policy)
from repro_torch.policies import (SharingPolicy, available, register, resolve)
from repro_torch.serving_plane import (ARRIVAL_KINDS, AdmissionPolicy,
                                       ArrivalProcess, ServingConfig,
                                       ServingPlane, admission_available,
                                       register_admission, resolve_admission)

__all__ = [
    # policies
    "SharingPolicy", "available", "register", "resolve",
    # engine
    "SimConfig", "SimResults", "build_sim_config", "run_policy",
    "schedule", "OnlineSlot", "OfflineJob", "dynamic_sm",
    "build_speed_predictor", "online_profile",
    "OFFLINE_MODEL_PROFILES", "ONLINE_SERVICE_PROFILES",
    # cluster
    "Scenario", "SCENARIOS", "scenario_by_name",
    "run_scenario", "run_policy_scenario",
    "check_schema", "REPORT_SCHEMA",
    # serving
    "ARRIVAL_KINDS", "ArrivalProcess", "AdmissionPolicy",
    "ServingConfig", "ServingPlane",
    "admission_available", "register_admission", "resolve_admission",
    # observability
    "ObsConfig", "ObsPlane", "OBS_SCHEMA",
    "MetricsRegistry", "PhaseProfiler",
    "canonical_json", "prometheus_text", "lint_prometheus",
    # alerting
    "ALERTS_SCHEMA", "AlertRule", "AlertEngine", "Incident",
    "register_alert_rule", "resolve_alert_rules",
    "alert_rules_available", "default_alert_rules",
    "read_incidents", "incidents_open_at",
    # forensics
    "INSPECT_SCHEMA", "inspect_run", "DIFF_SCHEMA", "diff_runs",
]
