"""Pair-profiling harness, ported from `repro/profiling/harness.py`: measure
online×offline co-location on one device.

  * Every catalog workload is first **executed for real**
    (:func:`repro_torch.profiling.workloads.execute`) — the hand-written CUDA
    kernels on the card — which yields an output checksum and the roofline
    step costs the virtual clock runs on.
  * Each (online, offline, SM-share) cell then runs a quantum-level device
    loop: online requests arrive on a seeded Poisson process and have strict
    priority; offline steps are non-preemptive and gated by the
    :class:`~repro_torch.core.protection.KernelThrottle` + PID duty
    controller, whose setpoint is the assigned SM share.
  * DCGM-style telemetry is sampled every window into the scalar
    :class:`~repro_torch.core.sysmonitor.SysMonitor` state machine, on a
    :class:`~repro_torch.core.protection.VirtualClock`.

The device loop is host code on the cost model, copied line for line: apart
from the checksums, the speed matrix is a pure function of (catalog, suite,
seed) and equals `repro`'s byte for byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.protection import (DeviceTelemetry, KernelThrottle,
                                         PIDConfig, PIDController, VirtualClock)
from repro_torch.core.sysmonitor import GPUState, SysMonitor, SysMonitorConfig
from repro_torch.profiling.workloads import (ExecutionRecord, Workload,
                                             build_catalog, catalog_by_role,
                                             execute)
from repro_torch.serving_plane import ArrivalProcess

MAX_COST_QUANTA = 250


@dataclasses.dataclass(frozen=True)
class SuiteConfig:
    """One named profiling campaign."""
    name: str
    shares: tuple[float, ...]
    horizon_quanta: int
    telemetry_window: int = 50


SUITES: dict[str, SuiteConfig] = {
    "smoke": SuiteConfig("smoke", (0.2, 0.5, 0.8), 4000),
    "full": SuiteConfig(
        "full", tuple(round(0.1 * k, 1) for k in range(1, 10)), 16000),
}


@dataclasses.dataclass
class CellResult:
    """One measured (online, offline, share) co-location cell."""
    online: str
    offline: str
    share: float
    online_slowdown: float        # mean latency / offline-free mean latency
    offline_tput: float           # completed steps / steps running alone
    achieved_share: float         # offline busy quanta / horizon
    online_p99_ms: float
    n_online: int
    n_offline: int
    monitor_healthy_frac: float


@dataclasses.dataclass
class _LoopStats:
    latencies: list
    off_done: int
    off_busy_total: int
    healthy_windows: int
    windows: int


def _arrivals(online: Workload, on_cost: int, horizon: int,
              seed: int) -> np.ndarray:
    """Seeded Poisson arrival times (quanta).  Seeded by the online workload
    only, so every cell of a pair sweep sees the same request stream and the
    slowdown comparison is paired."""
    mean_gap = on_cost / max(online.target_util, 0.05)
    process = ArrivalProcess.poisson(mean_gap=mean_gap,
                                     seed=[seed, online.seed])
    return process.times(horizon).astype(np.int64)


def _device_loop(on: Workload, off: Workload | None, on_cost: int,
                 off_cost: int, share: float | None, arrivals: np.ndarray,
                 suite: SuiteConfig, quantum_s: float) -> _LoopStats:
    """The quantum-level device loop; ``share=None`` disables the offline
    partner (the baseline cell)."""
    window = suite.telemetry_window
    window_s = window * quantum_s
    clock = VirtualClock()    # stamps SysMonitor telemetry; the PID steps
    # once per window with a dimensionless dt=1.0 (window quanta are far
    # below a virtual second, so clock-derived dt would freeze the loop)
    throttle = KernelThrottle(
        PIDController(PIDConfig(setpoint=share or 0.0, kp=0.5, ki=0.2,
                                kd=0.0, out_min=0.0, out_max=1.0),
                      initial=share or 0.0))
    monitor = SysMonitor(
        SysMonitorConfig(init_duration_s=2 * window_s,
                         readmit_base_s=10 * window_s,
                         overlimit_window_s=400 * window_s),
        now=0.0)
    on_prof = on.profile()
    off_prof = off.profile() if off is not None else None
    queue: list[int] = []
    lat: list[int] = []
    ai = 0
    on_left = off_left = 0
    cur_arrival = 0
    off_done = off_busy_total = 0
    on_busy_w = off_busy_w = 0
    healthy_windows = windows = 0
    for t in range(suite.horizon_quanta):
        while ai < arrivals.size and arrivals[ai] <= t:
            queue.append(int(arrivals[ai]))
            ai += 1
        if on_left == 0 and off_left == 0:
            if queue:
                cur_arrival = queue.pop(0)
                on_left = on_cost
            elif share is not None and throttle.should_launch(1.0):
                off_left = off_cost
        if on_left > 0:
            on_left -= 1
            on_busy_w += 1
            if on_left == 0:
                lat.append(t + 1 - cur_arrival)
        elif off_left > 0:
            off_left -= 1
            off_busy_w += 1
            off_busy_total += 1
            if off_left == 0:
                off_done += 1
        if (t + 1) % window == 0:
            clock.advance(window_s)
            occ_off = off_busy_w / window
            util = (on_busy_w + off_busy_w) / window
            if share is not None:
                throttle.duty = throttle.pid.update(occ_off, dt=1.0)
            sm_act = (on_busy_w * on_prof.sm_activity
                      + off_busy_w * (off_prof.sm_activity if off_prof
                                      else 0.0)) / window
            mem = on_prof.mem_bytes_frac + (off_prof.mem_bytes_frac
                                            if off_prof else 0.0)
            clk = 1590.0 - 440.0 * max(0.0, util - 0.85) / 0.15
            state, _ = monitor.update(
                DeviceTelemetry(ts=clock.time(), gpu_util=util,
                                sm_activity=sm_act, sm_clock=clk,
                                mem_used_frac=min(mem, 1.0)),
                now=clock.time())
            windows += 1
            healthy_windows += state == GPUState.HEALTHY
            on_busy_w = off_busy_w = 0
    return _LoopStats(lat, off_done, off_busy_total, healthy_windows, windows)


@dataclasses.dataclass
class PairProfiler:
    """Profiles every online×offline catalog pair across a share sweep.
    The catalog executes on ``device`` (the CUDA card unless
    ``device="cpu"``)."""
    suite: SuiteConfig
    seed: int = 0
    device: object = None
    catalog: dict[str, Workload] | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.catalog = self.catalog or build_catalog()
        self.records: dict[str, ExecutionRecord] = {}

    # ------------------------------------------------------------ execution
    def ensure_executed(self) -> dict[str, ExecutionRecord]:
        for name, w in self.catalog.items():
            if name not in self.records:
                self.records[name] = execute(w, device=self.device)
        return self.records

    def quantum_s(self) -> float:
        """The virtual-clock quantum: the cheapest catalog step's cost."""
        return min(w.cost_s() for w in self.catalog.values())

    def cost_quanta(self, w: Workload) -> int:
        q = self.quantum_s()
        return int(np.clip(round(w.cost_s() / q), 1, MAX_COST_QUANTA))

    # ------------------------------------------------------------ profiling
    def profile_pair(self, online: Workload,
                     offline: Workload) -> list[CellResult]:
        """Baseline + one cell per share for a pair; slowdowns are relative
        to the pair's own offline-free baseline under identical arrivals."""
        q = self.quantum_s()
        on_cost = self.cost_quanta(online)
        off_cost = self.cost_quanta(offline)
        arrivals = _arrivals(online, on_cost, self.suite.horizon_quanta,
                             self.seed)
        base = _device_loop(online, None, on_cost, off_cost, None, arrivals,
                            self.suite, q)
        base_lat = float(np.mean(base.latencies)) if base.latencies else 1.0
        alone = max(self.suite.horizon_quanta // off_cost, 1)
        cells = []
        for share in self.suite.shares:
            st = _device_loop(online, offline, on_cost, off_cost, share,
                              arrivals, self.suite, q)
            mean_lat = float(np.mean(st.latencies)) if st.latencies else base_lat
            p99 = (float(np.percentile(st.latencies, 99)) * q * 1e3
                   if st.latencies else 0.0)
            cells.append(CellResult(
                online=online.name, offline=offline.name, share=float(share),
                online_slowdown=max(1.0, mean_lat / max(base_lat, 1e-9)),
                offline_tput=float(np.clip(st.off_done / alone, 0.0, 1.0)),
                achieved_share=st.off_busy_total / self.suite.horizon_quanta,
                online_p99_ms=p99,
                n_online=len(st.latencies), n_offline=st.off_done,
                monitor_healthy_frac=st.healthy_windows / max(st.windows, 1)))
        return cells

    def run(self) -> tuple[dict[str, ExecutionRecord],
                           dict[tuple[str, str], list[CellResult]]]:
        """Execute the catalog, then profile the full online×offline grid."""
        self.ensure_executed()
        onlines, offlines = catalog_by_role(self.catalog)
        grid = {}
        for on in onlines:
            for off in offlines:
                grid[(on.name, off.name)] = self.profile_pair(on, off)
        return self.records, grid


def build_speed_matrix(suite: str = "smoke", seed: int = 0, device=None):
    """Execute + profile + assemble the versioned speed-matrix artifact."""
    from repro_torch.profiling.matrix import SpeedMatrix
    sc = SUITES[suite]
    prof = PairProfiler(sc, seed=seed, device=device)
    records, grid = prof.run()
    return SpeedMatrix.from_run(sc, seed, prof, records, grid)
