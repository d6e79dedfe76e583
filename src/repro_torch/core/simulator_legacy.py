"""The original per-device cluster simulator, kept as the reference engine
(copied from `repro/core/simulator_legacy.py`, the same behaviour).

This is the seed implementation of the trace-driven simulator: one Python
object per device, one Python loop iteration per device per tick.  It is
O(n_devices) interpreted work per tick and unusable at paper scale, but its
per-device control flow is easy to audit — so it stays as the ground truth
that the vectorized engine in ``core/simulator.py`` (both tick engines,
numpy and torch) is pinned against by a fixed-seed parity test.

Two deliberate deviations from the seed version keep the two engines
bit-reproducible against each other:

  * per-tick randomness is drawn as one ``(3, n_devices)`` uniform block
    (hardware-failure, error, error-kind rows) instead of ad-hoc scalar
    draws, and the error kind is derived via
    :func:`repro_torch.core.errors.error_from_uniform`;
  * QPS curves and online profiles are read from the shared vectorized
    providers (:class:`repro_torch.core.traces.QPSBank`,
    :func:`repro_torch.core.interference.online_profile_arrays`) so both
    engines see bitwise-identical trace inputs (numpy and libm transcendentals can
    differ in the last ULP).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.errors import MixedErrorHandler, error_from_uniform
from repro_torch.core.interference import (OFFLINE_MODEL_PROFILES,
                                           WorkloadProfile, memory_feasible,
                                           online_profile,
                                           online_profile_arrays,
                                           shared_performance)
from repro_torch.core.predictor import SpeedPredictor
from repro_torch.core.protection import DeviceTelemetry
from repro_torch.core.scheduler import (OfflineJob, OnlineSlot,
                                        SchedulerConfig, schedule)
from repro_torch.core.simulator import _BASE_LATENCY_MS, SimConfig, SimResults
from repro_torch.core.sysmonitor import SysMonitor
from repro_torch.core.traces import (SERVICES, OfflineJobSpec, OnlineQPS,
                                     QPSBank, make_trace)
from repro_torch.policies import resolve as resolve_policy

# the seven policies this reference engine implements per-device; newer
# registry policies are vectorized-engine-only (nothing pins them here)
_REFERENCE_POLICIES = ("muxflow", "muxflow-s", "muxflow-m", "muxflow-s-m",
                       "online-only", "time-sharing", "pb-time-sharing")


@dataclasses.dataclass
class _Device:
    idx: int
    gpu_type: str
    service: str
    service_idx: int
    monitor: SysMonitor
    job: "_RunningJob | None" = None
    failed_until: float = -1.0
    online_outage_until: float = -1.0
    base_latency_ms: float = 50.0
    speed: float = 1.0                         # A10 runs offline 1.35x faster


@dataclasses.dataclass
class _RunningJob:
    spec: OfflineJobSpec
    progress_s: float                          # in separate-execution seconds
    checkpoint_s: float                        # last checkpointed progress
    sm_share: float
    started_at: float
    shared_wall_s: float = 0.0                 # wall seconds on a device


class LegacyClusterSim:
    def __init__(self, cfg: SimConfig, predictor: SpeedPredictor | None = None):
        pol = resolve_policy(cfg.policy)
        if pol.name not in _REFERENCE_POLICIES:
            raise ValueError(
                f"reference engine implements only {_REFERENCE_POLICIES}, "
                f"got {pol.name!r}")
        self._pol_name = pol.name
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        if pol.needs_predictor and predictor is None:
            raise ValueError(f"policy {pol.name!r} needs a speed predictor")
        if predictor is not None and cfg.predictor_cache_quantum > 0:
            # mirror the vectorized engine's memoization so both engines
            # schedule on identical (quantized) predictions
            from repro_torch.core.predictor import CachedSpeedPredictor
            predictor = CachedSpeedPredictor(
                predictor, quantum=cfg.predictor_cache_quantum)
        self.predictor = predictor
        self.qps_bank = QPSBank([OnlineQPS(self.rng)
                                 for _ in range(cfg.n_devices)])
        self.devices = [
            _Device(
                idx=i,
                gpu_type=cfg.gpu_types[i % len(cfg.gpu_types)],
                service=SERVICES[i % len(SERVICES)],
                service_idx=i % len(SERVICES),
                monitor=SysMonitor(now=0.0),
                base_latency_ms=_BASE_LATENCY_MS[SERVICES[i % len(SERVICES)]],
                speed=1.35 if cfg.gpu_types[i % len(cfg.gpu_types)] == "A10" else 1.0,
            )
            for i in range(cfg.n_devices)
        ]
        self.models = tuple(OFFLINE_MODEL_PROFILES)
        self.feasible = {
            (svc, m): memory_feasible(online_profile(svc, 50.0),
                                      OFFLINE_MODEL_PROFILES[m],
                                      cfg.memory_quota)
            for svc in SERVICES for m in self.models}
        self.jobs = make_trace(cfg.trace, cfg.n_devices, cfg.horizon_s, cfg.seed)
        self.pending: list[OfflineJobSpec] = []
        self.err_handler = MixedErrorHandler(graceful_enabled=cfg.graceful_exit)
        self.finished: list[tuple] = []            # (spec, jct, wall, progress)
        self.evictions = 0
        self.executions = 0
        self.errors_injected = 0
        self.online_incidents = 0
        # accumulators
        self._lat_sum = self._lat_wsum = 0.0
        self._lat_samples: list[float] = []
        self._base_lat_sum = 0.0
        self._util_acc = np.zeros(3)          # gpu_util, sm_act, mem
        self._util_ticks = 0
        self._tput_sum = self._tput_ticks = 0.0
        self._timeline: dict[str, list] = {"t": [], "gpu_util": [], "sm_act": [],
                                           "mem": [], "slowdown": [], "tput": []}

    def _profile_at(self, d: _Device, on_arrs: dict) -> WorkloadProfile:
        i = d.idx
        return WorkloadProfile(
            name=d.service,
            gpu_util=float(on_arrs["gpu_util"][i]),
            sm_activity=float(on_arrs["sm_activity"][i]),
            sm_occupancy=float(on_arrs["sm_occupancy"][i]),
            mem_bw=float(on_arrs["mem_bw"][i]),
            exec_time_ms=float(on_arrs["exec_time_ms"][i]),
            mem_bytes_frac=float(on_arrs["mem_bytes_frac"][i]))

    def _service_idx_array(self) -> np.ndarray:
        return np.array([d.service_idx for d in self.devices], np.int64)

    # ------------------------------------------------------------------ run
    def run(self) -> SimResults:
        cfg = self.cfg
        t = 0.0
        job_i = 0
        next_sched = 0.0
        n_ticks = int(cfg.horizon_s / cfg.tick_s)
        self._sidx = self._service_idx_array()
        for _ in range(n_ticks):
            # job arrivals
            while job_i < len(self.jobs) and self.jobs[job_i].submit_s <= t:
                self.pending.append(self.jobs[job_i])
                job_i += 1
            # scheduling interval
            if self._pol_name != "online-only" and t >= next_sched:
                self._schedule(t)
                next_sched = t + cfg.schedule_interval_s
            self._tick(t)
            t += cfg.tick_s
        return self._results(t)

    # ------------------------------------------------------------- schedule
    def _schedule(self, t: float) -> None:
        cfg = self.cfg
        if self._pol_name in ("time-sharing", "pb-time-sharing"):
            # greedy FIFO packing: any alive device without a job
            for d in self.devices:
                if not self.pending:
                    break
                if d.job is None and d.failed_until <= t:
                    spec = self.pending.pop(0)
                    self._start_job(d, spec, 0.5, t)
            return
        if not self.pending:
            return
        sched_cfg = SchedulerConfig(
            use_dynamic_sm=self._pol_name in ("muxflow", "muxflow-m"),
            use_matching=self._pol_name in ("muxflow", "muxflow-s"),
            shard_size=cfg.shard_size)
        # free healthy devices (the paper only schedules onto Healthy GPUs)
        qps = self.qps_bank.qps(t)
        on_arrs = online_profile_arrays(self._sidx, qps, SERVICES)
        slots, free_devs = [], []
        for d in self.devices:
            if d.job is None and d.failed_until <= t and d.monitor.schedulable:
                slots.append(OnlineSlot(d.idx, d.gpu_type,
                                        self._profile_at(d, on_arrs)))
                free_devs.append(d)
        jobs = [OfflineJob(s.job_id, OFFLINE_MODEL_PROFILES[s.model],
                           s.duration_s) for s in self.pending]
        assignments = schedule(slots, jobs, self.predictor, sched_cfg)
        by_job = {s.job_id: s for s in self.pending}
        dev_by_id = {d.idx: d for d in self.devices}
        for a in assignments:
            spec = by_job.get(a.job_id)
            if spec is None:
                continue
            dev = dev_by_id[a.device_id]
            if not self.feasible[(dev.service, spec.model)]:
                continue  # xCUDA memory quota rejects the pairing
            by_job.pop(a.job_id)
            self.pending.remove(spec)
            self._start_job(dev, spec, a.sm_share, t)

    def _start_job(self, d: _Device, spec: OfflineJobSpec, share: float,
                   t: float) -> None:
        d.job = _RunningJob(spec=spec, progress_s=0.0, checkpoint_s=0.0,
                            sm_share=share, started_at=t)
        self.executions += 1

    # ----------------------------------------------------------------- tick
    def _tick(self, t: float) -> None:
        cfg = self.cfg
        dt = cfg.tick_s
        # shared RNG contract with the vectorized engine: one (3, n) block
        fail_u, err_u, kind_u = self.rng.random((3, len(self.devices)))
        qps_arr = self.qps_bank.qps(t)
        on_arrs = online_profile_arrays(self._sidx, qps_arr, SERVICES)
        lat_num = lat_den = 0.0
        base_num = 0.0
        util = np.zeros(3)
        tput_sum, tput_n = 0.0, 0
        slow_sum, slow_n = 0.0, 0
        for d in self.devices:
            # hardware failure / recovery
            if d.failed_until > t:
                continue
            if fail_u[d.idx] < dt / (cfg.device_mtbf_h * 3600.0):
                d.failed_until = t + cfg.device_repair_s
                self._evict(d, t, requeue=True, count=False)
                continue
            qps = float(qps_arr[d.idx])
            on = self._profile_at(d, on_arrs)
            slowdown, tput = 1.0, 0.0
            if d.job is not None:
                off = OFFLINE_MODEL_PROFILES[d.job.spec.model]
                slowdown, tput = self._policy_perf(d, on, off)
                tput *= d.speed
                # offline progress + periodic checkpoint
                d.job.progress_s += tput * dt
                d.job.shared_wall_s += dt
                if (d.job.progress_s - d.job.checkpoint_s
                        >= cfg.checkpoint_interval_s):
                    d.job.checkpoint_s = d.job.progress_s
                tput_sum += tput
                tput_n += 1
                # error injection (offline container errors)
                p_err = cfg.error_rate_per_job_hour * dt / 3600.0
                if err_u[d.idx] < p_err:
                    self._inject_error(d, t, float(kind_u[d.idx]))
                if d.job is not None and d.job.progress_s >= d.job.spec.duration_s:
                    self.finished.append((d.job.spec, t - d.job.spec.submit_s,
                                          d.job.shared_wall_s, d.job.progress_s))
                    d.job = None
            # telemetry + SysMonitor
            used_off = (min(d.job.sm_share,
                            OFFLINE_MODEL_PROFILES[d.job.spec.model].sm_activity)
                        if d.job else 0.0)
            tele = DeviceTelemetry(
                ts=t,
                gpu_util=min(1.0, on.gpu_util + (0.62 * used_off if d.job else 0.0)),
                sm_activity=min(1.0, on.sm_activity + used_off * 0.45),
                sm_clock=1590.0 - 420.0 * max(0.0, on.sm_activity + used_off - 0.8),
                mem_used_frac=min(1.0, on.mem_bytes_frac
                                  + (OFFLINE_MODEL_PROFILES[d.job.spec.model].mem_bytes_frac
                                     if d.job else 0.0)),
            )
            state, events = d.monitor.update(tele, t)
            if "evict" in events and d.job is not None:
                self._evict(d, t, requeue=True)
            # online latency accounting (weighted by qps)
            outage = d.online_outage_until > t
            lat = d.base_latency_ms * slowdown * (10.0 if outage else 1.0)
            lat_num += lat * qps
            base_num += d.base_latency_ms * qps
            lat_den += qps
            self._lat_samples.append(lat)
            slow_sum += slowdown
            slow_n += 1
            util += np.array([tele.gpu_util, tele.sm_activity, tele.mem_used_frac])
        self._lat_sum += lat_num
        self._base_lat_sum += base_num
        self._lat_wsum += lat_den
        self._util_acc += util
        self._util_ticks += 1
        if tput_n:
            self._tput_sum += tput_sum / tput_n
            self._tput_ticks += 1
        if int(t) % 600 == 0:
            n = max(len(self.devices), 1)
            self._timeline["t"].append(t)
            self._timeline["gpu_util"].append(util[0] / n)
            self._timeline["sm_act"].append(util[1] / n)
            self._timeline["mem"].append(util[2] / n)
            self._timeline["slowdown"].append(slow_sum / max(slow_n, 1))
            self._timeline["tput"].append(tput_sum / max(tput_n, 1) if tput_n else 0.0)

    def _policy_perf(self, d: _Device, on, off) -> tuple[float, float]:
        """(online slowdown, offline normalized tput) per policy."""
        pol = self._pol_name
        if pol.startswith("muxflow"):
            return shared_performance(on, off, d.job.sm_share)
        if pol == "time-sharing":
            # fair time slices (Gandiva-style): offline takes ~half the time
            off_duty = 0.5
            slowdown = 1.0 + 0.9 * off_duty * min(1.0, on.gpu_util * 2.2)
            return slowdown, off_duty * 0.9
        if pol == "pb-time-sharing":
            # online priority: offline fills idle *time* only (AntMan/PAI)
            idle = max(0.0, 1.0 - on.gpu_util)
            return 1.05, idle * 0.8
        return 1.0, 0.0

    def _inject_error(self, d: _Device, t: float, kind_u: float) -> None:
        self.errors_injected += 1
        kind = error_from_uniform(kind_u)
        handled = self.err_handler.handle(kind)
        if handled.propagated:
            d.online_outage_until = t + self.cfg.online_outage_s
            self.online_incidents += 1
        if handled.action.value == "graceful_exit":
            # graceful exit checkpoints before releasing
            if d.job is not None:
                d.job.checkpoint_s = d.job.progress_s
        self._evict(d, t, requeue=True, count=False)

    def _evict(self, d: _Device, t: float, requeue: bool, count: bool = True) -> None:
        if d.job is None:
            return
        if count:
            self.evictions += 1
        job = d.job
        d.job = None
        if requeue and job.progress_s < job.spec.duration_s:
            # resume from last checkpoint
            spec = dataclasses.replace(
                job.spec, duration_s=job.spec.duration_s - job.checkpoint_s,
                submit_s=job.spec.submit_s)
            spec.job_id = job.spec.job_id
            self.pending.insert(0, spec)

    # -------------------------------------------------------------- results
    def _results(self, t_end: float) -> SimResults:
        r = SimResults(policy=self._pol_name, trace=self.cfg.trace)
        r.n_jobs = len(self.jobs)
        r.n_finished = len(self.finished)
        if self.finished:
            r.avg_jct_s = float(np.mean([jct for _, jct, _, _ in self.finished]))
            r.makespan_s = float(max(jct + s.submit_s
                                     for s, jct, _, _ in self.finished))
        r.avg_latency_ms = self._lat_sum / max(self._lat_wsum, 1e-9)
        r.base_avg_latency_ms = self._base_lat_sum / max(self._lat_wsum, 1e-9)
        r.avg_slowdown = r.avg_latency_ms / max(r.base_avg_latency_ms, 1e-9)
        if self._lat_samples:
            r.p99_latency_ms = float(np.percentile(self._lat_samples, 99))
        util = self._util_acc / max(self._util_ticks * len(self.devices), 1)
        r.gpu_util, r.sm_activity, r.mem_used = map(float, util)
        r.avg_norm_tput = self._tput_sum / max(self._tput_ticks, 1e-9)
        # Eq. 3: oversold GPU — effective separate-execution seconds delivered
        # per wall-second the offline workloads spent sharing a device
        prog = sum(d.job.progress_s for d in self.devices if d.job)
        wall = sum(d.job.shared_wall_s for d in self.devices if d.job)
        prog += sum(p for _, _, _, p in self.finished)
        wall += sum(w for _, _, w, _ in self.finished)
        r.oversold_gpu = float(min(1.0, prog / max(wall, 1e-9)))
        r.evictions = self.evictions
        r.eviction_frac = self.evictions / max(self.executions, 1)
        r.errors_injected = self.errors_injected
        r.errors_propagated = sum(1 for h in self.err_handler.handled if h.propagated)
        r.online_incidents = self.online_incidents
        r.timeline = self._timeline
        return r
