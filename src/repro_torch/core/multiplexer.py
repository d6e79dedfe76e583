"""On-device space-sharing executor — the xCUDA analogue (copied from
`repro/core/multiplexer.py`, unchanged in behaviour).

One device loop interleaves an *online* serving function (priority; batched
decode requests with an SLO) and an *offline* training function (best-effort
microsteps).  The offline duty fraction plays the SM-percentage role:

  * the PID-driven KernelThrottle (protection.py, Eq. 1–2) gates offline
    microsteps from device telemetry (duty cycle ↔ U_SM, clock factor),
  * the MemoryQuota ledger enforces the offline HBM quota before the offline
    state is ever allocated,
  * GracefulExit freezes offline launches and checkpoints on SIGINT/SIGTERM,
  * an SLO guard (latency-based eviction) mirrors SysMonitor's Overlimit.

Runs on a virtual clock by default (deterministic tests) or wall-clock.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable

import numpy as np

from repro_torch.core.errors import GracefulExit
from repro_torch.core.protection import (KernelThrottle, MemoryQuota,
                                         PIDConfig, PIDController)


@dataclasses.dataclass
class Request:
    arrival: float
    request_id: int
    done: float | None = None

    @property
    def latency(self) -> float:
        return (self.done - self.arrival) if self.done is not None else float("inf")


@dataclasses.dataclass
class MuxConfig:
    slo_slowdown: float = 1.2        # protect online latency to <= 1.2x base
    max_batch: int = 8               # online serving batch cap
    quantum_s: float = 0.010         # scheduling quantum (one decode step)
    telemetry_interval_s: float = 0.1
    evict_after_violations: int = 50  # SysMonitor-style overlimit -> evict
    latency_budget_s: float | None = None   # absolute end-to-end budget
    quota_frac: float = 0.4
    device_bytes: int = 16 << 30


@dataclasses.dataclass
class MuxStats:
    served: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    base_ms: float = 0.0
    offline_steps: int = 0
    offline_duty: float = 0.0
    oversold: float = 0.0            # offline steps / steps it would do alone
    evicted: bool = False
    slo_violations: int = 0


class Multiplexer:
    """Interleaves online serving with offline training on one device.

    online_fn(batch_size) -> latency_s of one serving step (measured or
    modeled); offline_fn() -> duration_s of one training microstep.  With
    real step functions, pass wrappers that execute, synchronise and time
    them.
    """

    def __init__(self, online_fn: Callable[[int], float],
                 offline_fn: Callable[[], float],
                 base_step_s: float,
                 offline_step_s: float,
                 cfg: MuxConfig = MuxConfig(),
                 offline_state_bytes: int = 0):
        self.online_fn = online_fn
        self.offline_fn = offline_fn
        self.base_step_s = base_step_s
        self.offline_step_s = offline_step_s
        self.cfg = cfg
        self.quota = MemoryQuota(cfg.device_bytes, cfg.quota_frac)
        if offline_state_bytes:
            self.quota.alloc(offline_state_bytes)  # raises QuotaExceeded
        # PID setpoint: keep measured online latency at slo
        self.throttle = KernelThrottle(PIDController(
            PIDConfig(setpoint=cfg.slo_slowdown, kp=0.6, ki=0.1, kd=0.0,
                      out_min=0.0, out_max=0.95), initial=0.5))
        self.stats = MuxStats(base_ms=base_step_s * 1e3)
        self._latencies: list[float] = []
        self._violations = 0
        # callers may install a GracefulExit wired with their own
        # checkpoint/release callbacks (examples/serve_multiplex.py); the
        # run loop falls back to a bare freeze-only harness otherwise
        self.graceful: GracefulExit | None = None

    def run(self, arrivals: list[float], horizon_s: float,
            max_offline_steps: int | None = None) -> MuxStats:
        """Simulated-clock loop: serve `arrivals` (sorted times), fill idle
        quanta with offline microsteps while the PID allows."""
        cfg = self.cfg
        queue: list[Request] = []
        pending = [Request(a, i) for i, a in enumerate(sorted(arrivals))]
        t = 0.0
        i = 0
        offline_steps = 0
        duty_acc = duty_n = 0.0
        gex = self.graceful or GracefulExit(throttle=self.throttle)
        if gex.throttle is None:
            gex.throttle = self.throttle
        with gex:
            while t < horizon_s:
                while i < len(pending) and pending[i].arrival <= t:
                    heapq.heappush(queue, (pending[i].arrival, pending[i]))
                    i += 1
                if queue:
                    batch = [heapq.heappop(queue)[1]
                             for _ in range(min(cfg.max_batch, len(queue)))]
                    dt = self.online_fn(len(batch))
                    t += dt
                    budget = (cfg.latency_budget_s
                              or cfg.slo_slowdown * self.base_step_s * 4)
                    for r in batch:
                        r.done = t
                        self._latencies.append(r.latency)
                        if r.latency > budget:
                            self._violations += 1
                    # telemetry -> PID: measured slowdown of this step
                    slowdown = dt / max(self.base_step_s, 1e-9)
                    # PID drives duty so that slowdown tracks the SLO bound:
                    self.throttle.pid.cfg.setpoint = cfg.slo_slowdown
                    self.throttle.duty = self.throttle.pid.update(slowdown, dt)
                    duty_acc += self.throttle.duty
                    duty_n += 1
                    if self._violations >= cfg.evict_after_violations:
                        self.stats.evicted = True   # SysMonitor Overlimit
                        break
                elif (not self.throttle.frozen
                      and self.throttle.should_launch(cfg.quantum_s)
                      and (max_offline_steps is None
                           or offline_steps < max_offline_steps)):
                    dt = self.offline_fn()
                    t += dt
                    offline_steps += 1
                else:
                    # idle quantum (throttled): time still passes in quanta so
                    # the throttle keeps accruing offline credit
                    t += cfg.quantum_s
        s = self.stats
        s.served = len(self._latencies)
        if self._latencies:
            lat = np.array(self._latencies) * 1e3
            s.p50_ms = float(np.percentile(lat, 50))
            s.p99_ms = float(np.percentile(lat, 99))
        s.offline_steps = offline_steps
        s.offline_duty = duty_acc / max(duty_n, 1)
        alone = horizon_s / max(self.offline_step_s, 1e-9)
        s.oversold = offline_steps / max(alone, 1e-9)
        s.slo_violations = self._violations
        return s
