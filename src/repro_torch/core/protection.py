"""Workload-level performance protection (§4.1, the xCUDA analogue): the
parts the multiplexer needs, copied from `repro/core/protection.py` with the
same behaviour.

  * GPU-load law (Eq. 1–2): U_GPU = U_SM · a_C with the piecewise clock factor
    a_C around the SM-clock threshold T_SM.
  * A PID controller turning the GPU-load error into the offline duty
    fraction, gated by the kernel-launch throttle.
  * A memory-quota ledger for offline allocations.
  * A manually advanced clock, the GPU-monitor sample the SysMonitor
    reads (for the pair-profiling harness) and the rolling telemetry
    buffer (`GPUMonitor`) that keeps the last few minutes of samples.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Protocol


class Clock(Protocol):
    """Injectable time source for the PID/duty loop and telemetry buffers.

    Production uses :class:`WallClock`; tests inject a manually advanced
    clock so every timestamp and PID ``dt`` is an exact function of the
    inputs (no ``time.time()`` in the control loops)."""

    def time(self) -> float: ...


class WallClock:
    """The default clock: real wall time."""

    @staticmethod
    def time() -> float:
        return time.time()


class VirtualClock:
    """Deterministic, manually advanced clock."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def time(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t


@dataclasses.dataclass
class DeviceTelemetry:
    """One GPU-monitor sample (collection interval is milliseconds-level)."""
    ts: float
    gpu_util: float
    sm_activity: float
    sm_clock: float
    mem_used_frac: float
    power_w: float = 70.0
    temp_c: float = 60.0


class GPUMonitor:
    """Rolling telemetry buffer: 'stores the metrics for only several minutes
    because old data ... are useless for timely workload management.'"""

    def __init__(self, horizon_s: float = 300.0, clock: Clock | None = None):
        self.horizon_s = horizon_s
        self.clock = clock or WallClock()
        self.samples: list[DeviceTelemetry] = []

    def sample(self, gpu_util: float, sm_activity: float, sm_clock: float,
               mem_used_frac: float, **kw) -> DeviceTelemetry:
        """Record a sample stamped by the injected clock."""
        s = DeviceTelemetry(ts=self.clock.time(), gpu_util=gpu_util,
                            sm_activity=sm_activity, sm_clock=sm_clock,
                            mem_used_frac=mem_used_frac, **kw)
        self.record(s)
        return s

    def record(self, sample: DeviceTelemetry) -> None:
        self.samples.append(sample)
        cutoff = sample.ts - self.horizon_s
        while self.samples and self.samples[0].ts < cutoff:
            self.samples.pop(0)

    def latest(self) -> DeviceTelemetry | None:
        return self.samples[-1] if self.samples else None

    def mean(self, attr: str, window_s: float = 30.0) -> float:
        if not self.samples:
            return 0.0
        cutoff = self.samples[-1].ts - window_s
        vals = [getattr(s, attr) for s in self.samples if s.ts >= cutoff]
        return sum(vals) / max(len(vals), 1)


@dataclasses.dataclass(frozen=True)
class ClockFactorConfig:
    """Eq. 2 parameters.  a_L >> a_H (paper: prefer clock recovery)."""
    t_sm: float = 1350.0       # SM clock threshold (MHz, T4-like)
    c_high: float = 1590.0     # highest SM clock
    a_l: float = 4.0           # low-clock weight (a_L >> a_H)
    a_h: float = 0.5           # high-clock weight


def clock_factor(c_sm: float, cfg: ClockFactorConfig = ClockFactorConfig()) -> float:
    """Eq. 2: a_C as a function of the current SM clock."""
    if c_sm < cfg.t_sm:
        return 1.0 + cfg.a_l * (cfg.t_sm - c_sm) / cfg.t_sm
    return 1.0 - cfg.a_h * (c_sm - cfg.t_sm) / max(cfg.c_high - cfg.t_sm, 1e-9)


def gpu_load(u_sm: float, a_c: float) -> float:
    """Eq. 1: U_GPU = U_SM × a_C."""
    return u_sm * a_c


@dataclasses.dataclass
class PIDConfig:
    kp: float = 0.8
    ki: float = 0.15
    kd: float = 0.05
    setpoint: float = 0.85      # target GPU load
    out_min: float = 0.0
    out_max: float = 1.0
    integral_clamp: float = 2.0


class PIDController:
    """Classic PID on the GPU-load error; output = offline duty fraction.
    (The paper: 'xCUDA leverages the PID algorithm to provide more stable and
    robust controlling.')"""

    def __init__(self, cfg: PIDConfig = PIDConfig(), initial: float = 0.4):
        self.cfg = cfg
        self.integral = 0.0
        self.prev_error: float | None = None
        self.output = initial

    def update(self, measured_load: float, dt: float = 1.0) -> float:
        cfg = self.cfg
        error = cfg.setpoint - measured_load    # >0: room for more offline work
        self.integral = max(-cfg.integral_clamp,
                            min(cfg.integral_clamp, self.integral + error * dt))
        deriv = 0.0 if self.prev_error is None else (error - self.prev_error) / dt
        self.prev_error = error
        delta = cfg.kp * error + cfg.ki * self.integral + cfg.kd * deriv
        self.output = max(cfg.out_min, min(cfg.out_max, self.output + delta * dt))
        return self.output


class QuotaExceeded(RuntimeError):
    pass


class MemoryQuota:
    """Allocation ledger for the offline workload (paper: quota fixed to 40 %
    of device memory, because ~90 % of online workloads use < 60 %)."""

    def __init__(self, device_bytes: int, quota_frac: float = 0.4):
        self.device_bytes = int(device_bytes)
        self.quota_bytes = int(device_bytes * quota_frac)
        self.used = 0
        self._allocs: dict[int, int] = {}
        self._next = 0

    def alloc(self, nbytes: int) -> int:
        if self.used + nbytes > self.quota_bytes:
            raise QuotaExceeded(
                f"offline alloc {nbytes} exceeds quota "
                f"({self.used}/{self.quota_bytes} used)")
        self._next += 1
        self._allocs[self._next] = int(nbytes)
        self.used += int(nbytes)
        return self._next

    def free(self, handle: int) -> None:
        self.used -= self._allocs.pop(handle)

    def would_fit(self, nbytes: int) -> bool:
        return self.used + nbytes <= self.quota_bytes

    @property
    def frac_used(self) -> float:
        return self.used / max(self.device_bytes, 1)


class KernelThrottle:
    """The kernel-launch gate: xCUDA delays offline launches when U_GPU is
    high and releases them when it is low.  `should_launch` is consulted
    before every offline quantum; the PID keeps the duty near the allowance.
    """

    def __init__(self, pid: PIDController | None = None,
                 clock_cfg: ClockFactorConfig = ClockFactorConfig(),
                 clock: Clock | None = None):
        self.pid = pid or PIDController()
        self.clock_cfg = clock_cfg
        self.clock = clock or WallClock()
        self.duty = self.pid.output       # offline duty fraction in [0,1]
        self._credit = 0.0
        self._last_obs: float | None = None
        self.frozen = False               # graceful-exit freeze (§4.2)
        self.granted = 0                  # quanta `should_launch` granted
        self.refused = 0                  # and refused (frozen included)

    def observe(self, u_sm: float, c_sm: float, dt: float = 1.0) -> float:
        """Feed telemetry; returns the updated duty fraction."""
        load = gpu_load(u_sm, clock_factor(c_sm, self.clock_cfg))
        self.duty = self.pid.update(load, dt)
        return self.duty

    # below this, a sample is coalesced into the previous one: feeding the
    # PID a near-zero dt would blow up the derivative term (error delta
    # divided by dt) and slam the duty to a rail
    MIN_OBSERVE_DT_S = 1e-3

    def observe_now(self, u_sm: float, c_sm: float) -> float:
        """Feed telemetry stamped by the injected clock: ``dt`` is the time
        since the previous observation (1.0 on the first).  The duty loop
        never reads wall time directly — swap in a :class:`VirtualClock` and
        the whole PID trajectory is deterministic.  Samples arriving within
        ``MIN_OBSERVE_DT_S`` of the previous one are dropped (duty
        unchanged) rather than fed to the PID with an explosive dt."""
        now = self.clock.time()
        if self._last_obs is None:
            dt = 1.0
        else:
            dt = now - self._last_obs
            if dt < self.MIN_OBSERVE_DT_S:
                return self.duty
        self._last_obs = now
        return self.observe(u_sm, c_sm, dt)

    def should_launch(self, quantum: float = 1.0) -> bool:
        """Credit-based gate: offline work may take `duty` fraction of time.
        Each call counts in `granted` or `refused`."""
        if self.frozen:
            self.refused += 1
            return False
        self._credit += self.duty * quantum
        if self._credit >= quantum:
            self._credit -= quantum
            self.granted += 1
            return True
        self.refused += 1
        return False

    def freeze(self) -> None:
        self.frozen = True
