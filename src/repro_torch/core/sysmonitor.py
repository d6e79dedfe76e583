"""GPU-level protection: the SysMonitor state machine (§4.1, Fig. 6b),
copied from `repro/core/sysmonitor.py` (the scalar monitor; the vectorized
fleet monitor waits for the simulator).

Five states — Init, Healthy, Unhealthy, Overlimit, Disabled — driven by
multi-dimensional thresholds over the GPU-monitor metrics.  Offline workloads
may only be *scheduled* onto Healthy devices; entering Overlimit *evicts* the
offline workload; re-admission from Overlimit waits an exponentially growing
period in the number of Overlimit entries during the last two hours.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.protection import DeviceTelemetry


class GPUState(enum.Enum):
    INIT = "init"
    HEALTHY = "healthy"
    UNHEALTHY = "unhealthy"
    OVERLIMIT = "overlimit"
    DISABLED = "disabled"


@dataclasses.dataclass(frozen=True)
class MetricThresholds:
    """Per-metric (healthy_max, unhealthy_max) — beyond unhealthy_max is
    Overlimit.  sm_clock is inverted (low clock is bad)."""
    gpu_util: tuple = (0.92, 0.98)
    sm_activity: tuple = (0.85, 0.95)
    mem_used_frac: tuple = (0.90, 0.97)
    sm_clock_min: tuple = (1150.0, 900.0)   # (healthy_min, overlimit_min)
    temp_c: tuple = (82.0, 92.0)


@dataclasses.dataclass
class SysMonitorConfig:
    thresholds: MetricThresholds = dataclasses.field(default_factory=MetricThresholds)
    readmit_base_s: float = 60.0        # base of the exponential backoff
    overlimit_window_s: float = 7200.0  # "during the last two hours"
    readmit_cap_s: float = 3600.0
    init_duration_s: float = 5.0


class SysMonitor:
    """State machine over device telemetry.  `update()` returns the state and
    a list of events: 'evict' (entering Overlimit), 'schedulable' toggles."""

    def __init__(self, cfg: SysMonitorConfig | None = None, now: float = 0.0):
        self.cfg = cfg or SysMonitorConfig()
        self.state = GPUState.INIT
        self._init_at = now
        self._overlimit_entries: list[float] = []
        self._readmit_at: float | None = None

    # -- classification ----------------------------------------------------
    def _classify(self, m: DeviceTelemetry) -> str:
        t = self.cfg.thresholds
        level = "healthy"

        def worst(value, healthy_max, over_max):
            if value > over_max:
                return "overlimit"
            if value > healthy_max:
                return "unhealthy"
            return "healthy"

        checks = [
            worst(m.gpu_util, *t.gpu_util),
            worst(m.sm_activity, *t.sm_activity),
            worst(m.mem_used_frac, *t.mem_used_frac),
            worst(m.temp_c, *t.temp_c),
        ]
        # clock: below healthy_min unhealthy; below overlimit_min overlimit
        h_min, o_min = t.sm_clock_min
        if m.sm_clock < o_min:
            checks.append("overlimit")
        elif m.sm_clock < h_min:
            checks.append("unhealthy")
        if "overlimit" in checks:
            level = "overlimit"
        elif "unhealthy" in checks:
            level = "unhealthy"
        return level

    def _readmit_period(self, now: float) -> float:
        w = now - self.cfg.overlimit_window_s
        n = sum(1 for ts in self._overlimit_entries if ts >= w)
        return min(self.cfg.readmit_base_s * (2.0 ** max(n - 1, 0)),
                   self.cfg.readmit_cap_s)

    # -- transitions ---------------------------------------------------------
    def update(self, m: DeviceTelemetry, now: float) -> tuple[GPUState, list[str]]:
        events: list[str] = []
        level = self._classify(m)
        s = self.state
        if s == GPUState.DISABLED:
            return s, events
        if s == GPUState.INIT:
            if now - self._init_at >= self.cfg.init_duration_s:
                self.state = GPUState.HEALTHY
                events.append("schedulable")
            return self.state, events
        if s == GPUState.HEALTHY:
            if level == "overlimit":
                self._enter_overlimit(now, events)
            elif level == "unhealthy":
                self.state = GPUState.UNHEALTHY
                events.append("unschedulable")
        elif s == GPUState.UNHEALTHY:
            if level == "overlimit":
                self._enter_overlimit(now, events)
            elif level == "healthy":
                self.state = GPUState.HEALTHY
                events.append("schedulable")
        elif s == GPUState.OVERLIMIT:
            if level != "overlimit":
                if self._readmit_at is None:
                    self._readmit_at = now + self._readmit_period(now)
                elif now >= self._readmit_at:
                    self.state = GPUState.UNHEALTHY
                    self._readmit_at = None
            else:
                self._readmit_at = None   # still over limit: restart the wait
        return self.state, events

    def _enter_overlimit(self, now: float, events: list[str]) -> None:
        self.state = GPUState.OVERLIMIT
        self._overlimit_entries.append(now)
        self._readmit_at = None
        events.append("evict")

    def disable(self) -> None:
        self.state = GPUState.DISABLED

    @property
    def schedulable(self) -> bool:
        """Offline workloads can only be scheduled to Healthy GPUs."""
        return self.state == GPUState.HEALTHY
