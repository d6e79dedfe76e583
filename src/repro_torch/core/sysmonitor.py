"""GPU-level protection: the SysMonitor state machine (§4.1, Fig. 6b),
copied from `repro/core/sysmonitor.py`: the scalar monitor and the
vectorized fleet monitor the simulator runs.

Five states — Init, Healthy, Unhealthy, Overlimit, Disabled — driven by
multi-dimensional thresholds over the GPU-monitor metrics.  Offline workloads
may only be *scheduled* onto Healthy devices; entering Overlimit *evicts* the
offline workload; re-admission from Overlimit waits an exponentially growing
period in the number of Overlimit entries during the last two hours.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

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


# ---------------------------------------------------------------------------
# Vectorized fleet monitor (paper-scale simulation hot path)
# ---------------------------------------------------------------------------

# integer state codes for the struct-of-arrays monitor
S_INIT, S_HEALTHY, S_UNHEALTHY, S_OVERLIMIT, S_DISABLED = range(5)

_STATE_BY_CODE = (GPUState.INIT, GPUState.HEALTHY, GPUState.UNHEALTHY,
                  GPUState.OVERLIMIT, GPUState.DISABLED)


class VectorSysMonitor:
    """Struct-of-arrays :class:`SysMonitor` over ``n`` devices.

    One ``update`` call advances every *active* device's state machine with a
    handful of vectorized ops; transition semantics replicate the scalar
    monitor exactly (verified by an equivalence test).  Overlimit entry
    timestamps live in a fixed ring buffer per device — with the exponential
    re-admission backoff a device can physically accumulate only a handful of
    entries inside the two-hour window, so a small ring is lossless.
    """

    def __init__(self, n: int, cfg: SysMonitorConfig | None = None,
                 now: float = 0.0, ring: int = 64):
        self.cfg = cfg or SysMonitorConfig()
        self.n = n
        self.state = np.full(n, S_INIT, np.int8)
        self._init_at = np.full(n, now, np.float64)
        self._readmit_at = np.full(n, np.nan, np.float64)
        self._ol_times = np.full((n, ring), -np.inf, np.float64)
        self._ol_ptr = np.zeros(n, np.int64)

    # -- classification ----------------------------------------------------
    def classify(self, gpu_util, sm_activity, mem_used_frac, sm_clock,
                 temp_c) -> np.ndarray:
        """0 = healthy, 1 = unhealthy, 2 = overlimit (per device)."""
        t = self.cfg.thresholds
        h_min, o_min = t.sm_clock_min
        over = ((gpu_util > t.gpu_util[1]) | (sm_activity > t.sm_activity[1])
                | (mem_used_frac > t.mem_used_frac[1]) | (temp_c > t.temp_c[1])
                | (sm_clock < o_min))
        unhealthy = ((gpu_util > t.gpu_util[0]) | (sm_activity > t.sm_activity[0])
                     | (mem_used_frac > t.mem_used_frac[0])
                     | (temp_c > t.temp_c[0]) | (sm_clock < h_min))
        return np.where(over, 2, np.where(unhealthy, 1, 0)).astype(np.int8)

    # -- transitions -------------------------------------------------------
    def update(self, level: np.ndarray, now: float,
               active: np.ndarray | None = None) -> np.ndarray:
        """Advance active devices one step given their classification levels.
        Returns the eviction-event mask (devices entering Overlimit)."""
        if active is None:
            active = np.ones(self.n, bool)
        state = self.state
        init_m = active & (state == S_INIT)
        promote = init_m & (now - self._init_at >= self.cfg.init_duration_s)
        state[promote] = S_HEALTHY
        # the scalar monitor returns early from INIT, so freshly promoted
        # devices do not run the healthy-state logic until the next sample
        rest = active & ~init_m & (state != S_DISABLED)
        healthy_m = rest & (state == S_HEALTHY)
        unhealthy_m = rest & (state == S_UNHEALTHY)
        over_m = rest & (state == S_OVERLIMIT)
        evict = (healthy_m | unhealthy_m) & (level == 2)
        state[healthy_m & (level == 1)] = S_UNHEALTHY
        state[unhealthy_m & (level == 0)] = S_HEALTHY
        ei = np.flatnonzero(evict)
        if ei.size:
            state[ei] = S_OVERLIMIT
            self._readmit_at[ei] = np.nan
            self.push_overlimit(ei, now)
        # Overlimit: wait out the exponential re-admission period
        exit_lvl = over_m & (level != 2)
        had_wait = ~np.isnan(self._readmit_at)
        start_wait = exit_lvl & ~had_wait
        readmit = exit_lvl & had_wait & (now >= self._readmit_at)
        self._readmit_at[over_m & (level == 2)] = np.nan
        si = np.flatnonzero(start_wait)
        if si.size:
            self._readmit_at[si] = now + self.wait_periods(si, now)
        state[readmit] = S_UNHEALTHY
        self._readmit_at[readmit] = np.nan
        return evict

    # -- ring-buffer primitives (shared with the torch tick engine,
    #    which keeps the Overlimit ring host-side and sparse) -------------
    def push_overlimit(self, ei: np.ndarray, now: float) -> None:
        """Record Overlimit entries for devices ``ei`` at time ``now``."""
        ring = self._ol_times.shape[1]
        self._ol_times[ei, self._ol_ptr[ei] % ring] = now
        self._ol_ptr[ei] += 1

    def wait_periods(self, si: np.ndarray, now: float) -> np.ndarray:
        """Exponential re-admission periods for devices ``si`` entering the
        wait at ``now`` (doubling per Overlimit entry in the window).  2**k
        is an integer shift (exact; capping the exponent at 52 cannot
        change the min with the cap)."""
        w = now - self.cfg.overlimit_window_s
        n_entries = (self._ol_times[si] >= w).sum(axis=1)
        e = np.minimum(np.maximum(n_entries - 1, 0), 52)
        return np.minimum(
            self.cfg.readmit_base_s * (np.int64(1) << e).astype(np.float64),
            self.cfg.readmit_cap_s)

    def disable(self, idx) -> None:
        self.state[idx] = S_DISABLED

    @property
    def schedulable(self) -> np.ndarray:
        return self.state == S_HEALTHY

    def states(self) -> list[GPUState]:
        return [_STATE_BY_CODE[c] for c in self.state]
