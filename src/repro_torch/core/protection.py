"""Workload-level performance protection (§4.1, the xCUDA analogue): the
parts the multiplexer needs, copied from `repro/core/protection.py` with the
same behaviour.

  * GPU-load law (Eq. 1–2): U_GPU = U_SM · a_C with the piecewise clock factor
    a_C around the SM-clock threshold T_SM.
  * A PID controller turning the GPU-load error into the offline duty
    fraction, gated by the kernel-launch throttle.
  * A memory-quota ledger for offline allocations.
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
        """Credit-based gate: offline work may take `duty` fraction of time."""
        if self.frozen:
            return False
        self._credit += self.duty * quantum
        if self._credit >= quantum:
            self._credit -= quantum
            return True
        return False

    def freeze(self) -> None:
        self.frozen = True
