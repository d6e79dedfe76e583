"""Deterministic alerting: burn-rate rules, alert state machines, incidents.

The operator loop MuxFlow's §5 deployment story implies: *watch* the
metrics stream for online harm (SLO burn, error storms, device-disable
spikes, broken slowdown guarantees) and attribute it to a pool or service.
Everything here is evaluated at metrics-window boundaries from per-window
inputs the :class:`~repro_torch.obs.metrics.FleetMetricsRecorder` already
accumulates, so alerting inherits the plane's determinism contract: the
``incidents.jsonl`` stream is byte-identical across same-seed runs, across
processes, and across the numpy/torch tick engines.

Pieces:

* :class:`AlertRule` — one declarative rule: a window signal, a scope
  (``fleet`` / ``pool`` / ``service``), a strict ``>`` threshold, and the
  multi-window burn-rate extension (fast window catches the spike, the
  trailing ``slow_windows`` mean filters blips).  Rules live in a string
  registry (:func:`register_alert_rule` / :func:`resolve_alert_rules`) like
  policies and admission controllers.
* :class:`AlertEngine` — per (rule, target) state machines
  (``inactive → pending → firing → resolved``) producing typed
  :class:`Alert` transition rows and an :class:`Incident` lifecycle,
  streamed through the canonical JSONL exporter.
* :func:`read_incidents` — parse an ``incidents.jsonl`` back into
  :class:`Incident` timelines (what ``inspect``/``diff`` report at a tick).

Copied from `repro/obs/alerts.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses
import json

ALERTS_SCHEMA = "repro.obs.alerts/v1"

#: SLO error-budget objective the burn-rate signal is normalized against:
#: ``burn = (1 - window attainment) / (1 - objective)`` — burn 1.0 spends
#: the budget exactly at the sustainable rate, 14.4 exhausts a 30-day
#: budget in 2 days (the classic page threshold).
ATTAINMENT_OBJECTIVE = 0.99

SEVERITIES = ("page", "ticket")
SCOPES = ("fleet", "pool", "service")
RULE_KINDS = ("threshold", "burn_rate")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One deterministic rule evaluated at every metrics-window boundary.

    A window *breaches* when its signal value is strictly above
    ``threshold``; ``burn_rate`` rules additionally require the trailing
    ``slow_windows``-window mean to exceed ``slow_threshold``.
    ``for_windows`` consecutive breaches arm → fire (opening an
    :class:`Incident`); ``clear_windows`` consecutive clean windows
    resolve it.
    """
    name: str
    signal: str                   # window-signal key within the scope
    scope: str                    # "fleet" | "pool" | "service"
    threshold: float
    severity: str = "ticket"      # "page" | "ticket"
    kind: str = "threshold"       # "threshold" | "burn_rate"
    for_windows: int = 1
    clear_windows: int = 1
    slow_windows: int = 1
    slow_threshold: float | None = None
    description: str = ""

    def __post_init__(self):
        if self.scope not in SCOPES:
            raise ValueError(f"rule {self.name!r}: scope {self.scope!r} "
                             f"not in {SCOPES}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"rule {self.name!r}: severity "
                             f"{self.severity!r} not in {SEVERITIES}")
        if self.kind not in RULE_KINDS:
            raise ValueError(f"rule {self.name!r}: kind {self.kind!r} "
                             f"not in {RULE_KINDS}")
        if self.for_windows < 1 or self.clear_windows < 1:
            raise ValueError(f"rule {self.name!r}: for_windows and "
                             "clear_windows must be >= 1")
        if self.slow_windows < 1:
            raise ValueError(f"rule {self.name!r}: slow_windows must "
                             "be >= 1")

    def breach(self, value: float, slow_mean: float) -> bool:
        """Strict ``>`` so breach counts are monotone non-increasing in the
        threshold (a property test pins this)."""
        if self.kind == "burn_rate" and self.slow_threshold is not None:
            return value > self.threshold and slow_mean > self.slow_threshold
        return value > self.threshold


@dataclasses.dataclass(frozen=True)
class Alert:
    """A typed alert transition — one ``kind="alert"`` JSONL row."""
    t: float
    rule: str
    target: str
    state: str           # pending | firing | inactive | resolved
    value: float
    threshold: float
    severity: str

    def row(self) -> dict:
        return {"kind": "alert", "t": self.t, "rule": self.rule,
                "target": self.target, "state": self.state,
                "value": self.value, "threshold": self.threshold,
                "severity": self.severity}


@dataclasses.dataclass
class Incident:
    """One open → firing → resolved lifecycle for a (rule, target)."""
    id: int
    rule: str
    target: str
    severity: str
    opened_t: float
    resolved_t: float | None = None
    windows: int = 0              # breach windows attributed to the incident
    peak: float = 0.0             # worst signal value while open

    def open_at(self, t: float) -> bool:
        return self.opened_t <= t and (self.resolved_t is None
                                       or t < self.resolved_t)

    def row(self) -> dict:
        return {"kind": "incident", "id": self.id, "rule": self.rule,
                "target": self.target, "severity": self.severity,
                "opened_t": self.opened_t, "resolved_t": self.resolved_t,
                "windows": self.windows, "peak": self.peak}


# ------------------------------------------------------------------ registry
ALERT_RULES: dict[str, AlertRule] = {}


def register_alert_rule(rule: AlertRule) -> AlertRule:
    """Add a rule to the catalog (names are unique, like policies)."""
    if rule.name in ALERT_RULES:
        raise ValueError(f"alert rule {rule.name!r} already registered")
    ALERT_RULES[rule.name] = rule
    return rule


def alert_rules_available() -> tuple:
    return tuple(sorted(ALERT_RULES))


def default_alert_rules() -> tuple:
    """The full catalog, sorted by name (the engine's evaluation order)."""
    return tuple(ALERT_RULES[n] for n in sorted(ALERT_RULES))


def resolve_alert_rules(names) -> tuple:
    """A named subset of the catalog, sorted by name; unknown names raise
    with the available catalog in the message."""
    out = []
    for n in sorted(set(names)):
        rule = ALERT_RULES.get(n)
        if rule is None:
            raise ValueError(f"unknown alert rule {n!r}; available: "
                             f"{', '.join(alert_rules_available())}")
        out.append(rule)
    return tuple(out)


# The default catalog.  Thresholds are tuned so the quiet `smoke` scenario
# stays incident-free (a property test pins this) while `fault-storm`
# (campaign at 1.0 errors/device-hour) reliably opens error-rate incidents.
register_alert_rule(AlertRule(
    "slo-burn-fast", signal="burn_rate", scope="service", threshold=14.4,
    severity="page", kind="burn_rate", slow_windows=6, slow_threshold=6.0,
    clear_windows=2,
    description="fast SLO burn: one window burning >14.4x budget while the "
                "6-window mean burns >6x — page before the budget is gone"))
register_alert_rule(AlertRule(
    "slo-burn-slow", signal="burn_rate", scope="service", threshold=3.0,
    severity="ticket", kind="burn_rate", slow_windows=6, slow_threshold=1.0,
    for_windows=2, clear_windows=3,
    description="slow SLO burn: sustained >3x budget spend with the "
                "6-window mean above sustainable — ticket-grade erosion"))
register_alert_rule(AlertRule(
    "serving-p99", signal="p99_slo_ratio", scope="service", threshold=1.0,
    severity="ticket", for_windows=2, clear_windows=2,
    description="window p99 latency above the service SLO for two "
                "consecutive windows"))
register_alert_rule(AlertRule(
    "error-rate", signal="errors_per_device_hour", scope="fleet",
    threshold=0.25, severity="ticket", for_windows=2, clear_windows=2,
    description="offline-container error rate above 0.25/device-hour for "
                "two consecutive windows (fig7 error-mix storm)"))
register_alert_rule(AlertRule(
    "incident-spike", signal="online_incidents", scope="fleet",
    threshold=2.5, severity="page",
    description="three or more errors propagated to the online service in "
                "one window — the §4.2 guarantee is broken"))
register_alert_rule(AlertRule(
    "device-disable-spike", signal="device_disables_per_1k_hour",
    scope="pool", threshold=700.0, severity="ticket", for_windows=2,
    clear_windows=2,
    description="SysMonitor healthy->non-schedulable transitions above "
                "700 per 1k device-hours in a pool for two consecutive "
                "windows (background agent churn stays below this)"))
register_alert_rule(AlertRule(
    "online-slowdown", signal="busy_slowdown", scope="pool", threshold=1.2,
    severity="page", for_windows=4, clear_windows=2,
    description="window-mean online slowdown on shared devices above the "
                "1.2x guarantee for four consecutive windows — transient "
                "co-location spikes decay faster than this"))
# Chaos-plane rules: their signals only exist when a ChaosCampaign is wired
# in (the engine skips missing signals), so quiet runs stay incident-free.
register_alert_rule(AlertRule(
    "chaos-unrecovered", signal="chaos_open_faults", scope="fleet",
    threshold=0.5, severity="page", for_windows=3, clear_windows=1,
    description="an injected fault has stayed open (no paired recovery "
                "event) for three consecutive windows — a degradation-"
                "ladder rung failed to engage"))
register_alert_rule(AlertRule(
    "wal-retry-storm", signal="chaos_store_retries", scope="fleet",
    threshold=8.0, severity="ticket", for_windows=2, clear_windows=2,
    description="more than eight WAL IO retries per window for two "
                "consecutive windows — the bounded-retry rung is masking "
                "a persistent storage fault"))
register_alert_rule(AlertRule(
    "chaos-brownout", signal="chaos_brownout_shed", scope="fleet",
    threshold=0.5, severity="ticket", clear_windows=2,
    description="the serving brownout rung shed requests this window — "
                "overload protection engaged at the cost of SLO budget"))


# ------------------------------------------------------------------- engine
class _RuleState:
    """One (rule, target) state machine."""
    __slots__ = ("state", "breaches", "clears", "peak", "ring", "incident")

    def __init__(self):
        self.state = "inactive"
        self.breaches = 0            # consecutive breach windows
        self.clears = 0              # consecutive clean windows while firing
        self.peak = 0.0              # worst value over the current breach run
        self.ring: list[float] = []  # trailing values (slow-window mean)
        self.incident: Incident | None = None


class AlertEngine:
    """Evaluates the rule catalog at every metrics-window boundary.

    ``on_window(t, signals)`` consumes one deterministic per-window signal
    document (built by the metrics recorder from its existing accumulators)
    and advances every (rule, target) state machine; transitions and
    incident open/resolve rows stream through the canonical writer, and
    ``finalize`` appends one ``kind="incident"`` summary row per incident —
    the timeline ``inspect``/``diff`` read back.
    """

    def __init__(self, writer, rules=None, *, window_s: float):
        self.writer = writer
        rules = tuple(rules) if rules else default_alert_rules()
        self.rules = tuple(sorted(rules, key=lambda r: r.name))
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.window_s = float(window_s)
        self.windows = 0
        self.breach_windows = 0      # (rule, target, window) breach count
        self.transitions = 0
        self.incidents: list[Incident] = []
        self._next_id = 0
        self._states: dict[tuple, _RuleState] = {}
        writer.write({"kind": "header", "schema": ALERTS_SCHEMA,
                      "window_s": self.window_s,
                      "objective": ATTAINMENT_OBJECTIVE, "rules": names})

    # ------------------------------------------------------------ per-window
    def on_window(self, t: float, signals: dict) -> None:
        """Evaluate every rule against one window's signals.  Rules iterate
        sorted by name and targets sorted by key, so row order (and hence
        the stream digest) is deterministic."""
        for rule in self.rules:
            scope = signals.get(rule.scope)
            if scope is None:
                continue
            if rule.scope == "fleet":
                items = (("fleet", scope),)
            else:
                items = tuple((k, scope[k]) for k in sorted(scope))
            for target, vals in items:
                value = vals.get(rule.signal)
                if value is None:
                    continue
                self._eval(t, rule, target, float(value))
        self.windows += 1

    def _eval(self, t: float, rule: AlertRule, target: str,
              value: float) -> None:
        key = (rule.name, target)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _RuleState()
        st.ring.append(value)
        if len(st.ring) > rule.slow_windows:
            del st.ring[0]
        slow_mean = sum(st.ring) / len(st.ring)
        if rule.breach(value, slow_mean):
            self.breach_windows += 1
            st.clears = 0
            st.breaches += 1
            st.peak = value if st.breaches == 1 else max(st.peak, value)
            if st.state == "firing":
                st.incident.windows += 1
                if value > st.incident.peak:
                    st.incident.peak = value
            elif st.breaches >= rule.for_windows:
                st.state = "firing"
                self._transition(t, rule, target, "firing", value)
                inc = Incident(self._next_id, rule.name, target,
                               rule.severity, t, windows=st.breaches,
                               peak=st.peak)
                self._next_id += 1
                st.incident = inc
                self.incidents.append(inc)
                self.writer.write({"kind": "incident_open", "t": t,
                                   "id": inc.id, "rule": rule.name,
                                   "target": target,
                                   "severity": rule.severity})
            elif st.state == "inactive":
                st.state = "pending"
                self._transition(t, rule, target, "pending", value)
        else:
            st.breaches = 0
            if st.state == "pending":
                st.state = "inactive"
                self._transition(t, rule, target, "inactive", value)
            elif st.state == "firing":
                st.clears += 1
                if st.clears >= rule.clear_windows:
                    st.state = "inactive"
                    st.clears = 0
                    self._transition(t, rule, target, "resolved", value)
                    inc = st.incident
                    inc.resolved_t = t
                    st.incident = None
                    self.writer.write({"kind": "incident_resolve", "t": t,
                                       "id": inc.id, "rule": rule.name,
                                       "target": target})

    def _transition(self, t: float, rule: AlertRule, target: str,
                    state: str, value: float) -> None:
        self.transitions += 1
        self.writer.write(Alert(t, rule.name, target, state, value,
                                rule.threshold, rule.severity).row())

    # ------------------------------------------------------------ lifecycle
    def finalize(self, t_end: float) -> None:
        """Append the incident timeline (one summary row per incident, id
        order — open incidents keep ``resolved_t: null``) and a footer."""
        for inc in self.incidents:
            self.writer.write(inc.row())
        self.writer.write({"kind": "footer", "t_end": t_end,
                           "windows": self.windows,
                           "breach_windows": self.breach_windows,
                           "incidents": len(self.incidents),
                           "open_end": self.open_count()})

    def open_count(self) -> int:
        return sum(1 for i in self.incidents if i.resolved_t is None)

    def summary(self) -> dict:
        """The report's ``"incidents"`` section: stream identity plus a
        compact timeline (deterministic — never paths or wall clock)."""
        by_rule: dict[str, int] = {}
        by_sev: dict[str, int] = {}
        for inc in self.incidents:
            by_rule[inc.rule] = by_rule.get(inc.rule, 0) + 1
            by_sev[inc.severity] = by_sev.get(inc.severity, 0) + 1
        return {"schema": ALERTS_SCHEMA, "rows": self.writer.rows,
                "digest": self.writer.digest(),
                "rules": [r.name for r in self.rules],
                "windows": self.windows,
                "breach_windows": self.breach_windows,
                "transitions": self.transitions,
                "total": len(self.incidents),
                "open_end": self.open_count(),
                "by_rule": dict(sorted(by_rule.items())),
                "by_severity": dict(sorted(by_sev.items())),
                "timeline": [inc.row() for inc in self.incidents[:200]]}


# ------------------------------------------------------------------ readers
def read_incidents(path: str) -> list[Incident]:
    """Parse the ``kind="incident"`` timeline rows out of an
    ``incidents.jsonl`` (written at finalize, id order)."""
    out: list[Incident] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if row.get("kind") != "incident":
                continue
            out.append(Incident(
                id=row["id"], rule=row["rule"], target=row["target"],
                severity=row["severity"], opened_t=row["opened_t"],
                resolved_t=row["resolved_t"], windows=row["windows"],
                peak=row["peak"]))
    return out


def incidents_open_at(incidents, t: float) -> list[Incident]:
    """The sub-timeline open at sim time ``t`` (id order preserved)."""
    return [inc for inc in incidents if inc.open_at(t)]
