"""Trace-driven cluster simulator (§7.1: "Inspired by [Tiresias, Muri], we
build a simulator to evaluate a broader set of configurations, traces, and
baselines").

Fixed-tick discrete-event simulation of a GPU cluster where every device
hosts one online workload (diurnal QPS) and at most one offline workload.
Implements the full MuxFlow stack — dynamic SM allocation, the speed
predictor + KM matching scheduler, SysMonitor protection/eviction, the mixed
error handler, checkpoint/restart fault tolerance.  GPU-sharing behavior
(what gets scheduled, with what SM shares, and how a sharing pair performs)
is delegated to a pluggable :class:`repro_torch.policies.SharingPolicy` resolved
through the policy registry — the paper's baselines (Online-only,
Gandiva-style time-sharing, AntMan/PAI-style priority time-sharing, the
MuxFlow-S/-M/-S-M ablations) and the related-work policies all live in
:mod:`repro_torch.policies`, not here.

This module holds the *vectorized* engine: device state lives in
struct-of-arrays numpy form (:class:`FleetState`) and each 30 s tick is a
handful of array ops, so a 20 000-device × 12-hour trace simulates in minutes
on a CPU.  Scheduling rounds go through the partitioned (sharded) matcher in
``core/scheduler.py``, on weights the speed predictor answers on its device.

Copied from `repro/core/simulator.py`: the same RNG stream ((3, n_devices)
uniforms a tick), the same accounting and the same scheduling-boundary
predicate, so under one predictor both packages give equal
:class:`SimResults`.  The tick core has two engines: ``"numpy"`` (the
reference, :meth:`ClusterSim._dense_core_numpy`) and ``"torch"``
(:mod:`repro_torch.core.engine_torch`, float64 on the CUDA card unless
``SimConfig.device="cpu"``), bitwise equal to each other.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.dynamic_sm import dynamic_sm_array, fixed_sm
from repro_torch.core.errors import ERROR_MIX, MixedErrorHandler
from repro_torch.core.interference import (OFFLINE_MODEL_PROFILES,
                                     ONLINE_SERVICE_PROFILES,
                                     memory_feasible, online_profile,
                                     online_profile_arrays)
from repro_torch.core.matching import IncrementalMatcher
from repro_torch.core.predictor import CachedSpeedPredictor, SpeedPredictor
from repro_torch.core.scheduler import (OfflineJob, build_weight_grid_arrays,
                                  solve_matching, static_weight_grid)
from repro_torch.core.sysmonitor import VectorSysMonitor
from repro_torch.core.traces import (SERVICES, OfflineJobSpec, OnlineQPS, QPSBank,
                               make_trace)
from repro_torch.policies import SharingPolicy
from repro_torch.policies import resolve as resolve_policy

DEFAULT_HBM_GB = 16.0     # T4-class device the workload profiles are scaled to

_BASE_LATENCY_MS = {s: ONLINE_SERVICE_PROFILES[s]["base_latency_ms"]
                    for s in ONLINE_SERVICE_PROFILES}
_P99_BIN_MS = 0.05
_P99_MAX_MS = 10_000.0


ENGINES = ("numpy", "torch")


@dataclasses.dataclass
class SimConfig:
    # registry name (see repro_torch.policies.available()) or a SharingPolicy
    # instance; resolved once at engine construction
    policy: str | SharingPolicy = "muxflow"
    n_devices: int = 200
    horizon_s: float = 12 * 3600.0
    tick_s: float = 30.0
    schedule_interval_s: float = 900.0        # 15 min (paper's testbed)
    checkpoint_interval_s: float = 300.0
    restart_delay_s: float = 90.0             # image pull + restore
    trace: str = "A"
    seed: int = 0
    gpu_types: tuple = ("T4", "T4", "T4", "A10")   # heterogeneous mix
    error_rate_per_job_hour: float = 0.05      # offline container errors
    graceful_exit: bool = True                 # MuxFlow's §4.2 mechanism
    device_mtbf_h: float = 4000.0              # hardware failures
    device_repair_s: float = 1800.0
    online_outage_s: float = 120.0             # when an error propagates
    memory_quota: float = 0.4
    # paper-scale knobs
    shard_size: int = 256                      # matcher partition bound
    predictor_cache_quantum: float = 0.02      # >0: memoize quantized rows
    # tick-engine backend: "numpy" (reference) or "torch" (float64 tick
    # core on a torch device, bitwise-identical trajectories — see
    # core/engine_torch.py)
    engine: str = "numpy"
    incremental_matching: bool = True          # reuse clean shards per round
    # the torch engine's device: None is the CUDA card (raises without
    # one); pass "cpu" to ask for the CPU.  The numpy engine ignores it.
    device: str | None = None


@dataclasses.dataclass
class SimResults:
    policy: str
    trace: str
    # online
    avg_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    base_avg_latency_ms: float = 0.0
    avg_slowdown: float = 1.0
    # offline
    n_jobs: int = 0
    n_finished: int = 0
    avg_jct_s: float = 0.0
    makespan_s: float = 0.0
    oversold_gpu: float = 0.0                  # Eq. 3
    avg_norm_tput: float = 0.0
    evictions: int = 0
    eviction_frac: float = 0.0
    # utilization (cluster averages)
    gpu_util: float = 0.0
    sm_activity: float = 0.0
    mem_used: float = 0.0
    # safety
    errors_injected: int = 0
    errors_propagated: int = 0
    online_incidents: int = 0
    # timeline (downsampled) for figure benchmarks
    timeline: dict = dataclasses.field(default_factory=dict)


class SimHooks:
    """Observation/control seam for an external driver (a control plane).

    Subclass and override any subset; every method is a no-op by default, and
    the simulator only calls them when a hooks object is installed, so the
    default (hook-less) run is byte-identical to the pre-hook engine.  All
    callbacks receive the simulator itself so implementations can read fleet
    state without the engine having to marshal it per event.
    """

    def on_job_start(self, sim: "ClusterSim", t: float, device: int,
                     spec, share: float) -> None:
        """An offline job was placed on ``device`` with SM share ``share``."""

    def on_job_finish(self, sim: "ClusterSim", t: float, device: int,
                      spec, jct_s: float, wall_s: float,
                      progress_s: float) -> None:
        """An offline job ran to completion."""

    def on_job_evict(self, sim: "ClusterSim", t: float, device: int,
                     spec, reason: str, progress_s: float,
                     checkpoint_s: float, requeued: bool) -> None:
        """An offline job was evicted (``reason`` in ``{"overlimit", "error",
        "device_failure", "autoscale", "external"}``)."""

    def on_error(self, sim: "ClusterSim", t: float, device: int,
                 handled) -> None:
        """An offline container error was injected (``handled`` is the
        :class:`~repro_torch.core.errors.HandledError`)."""

    def on_device_fail(self, sim: "ClusterSim", t: float, device: int,
                       until: float) -> None:
        """A hardware failure took ``device`` down until ``until``."""

    def on_schedule(self, sim: "ClusterSim", t: float, n_free: int,
                    n_pending_before: int, n_assigned: int,
                    wall_s: float) -> None:
        """A scheduling round completed (``wall_s`` is real wall time)."""

    def on_tick_end(self, sim: "ClusterSim", t: float,
                    telemetry: dict) -> None:
        """End of a tick; ``telemetry`` holds per-device arrays (qps,
        gpu_util, sm_activity, mem_used, sm_clock, level, busy, active,
        slowdown, tput).  Arrays are the engine's own buffers — copy what you
        keep."""


@dataclasses.dataclass
class FleetState:
    """Struct-of-arrays device state — the vectorized engine's hot data."""
    has_job: np.ndarray          # bool (n,)
    model_idx: np.ndarray        # int64 (n,) — offline model of current job
    sm_share: np.ndarray         # float64 (n,)
    progress: np.ndarray         # float64 (n,) separate-execution seconds
    checkpoint: np.ndarray       # float64 (n,) last checkpointed progress
    started: np.ndarray          # float64 (n,)
    wall: np.ndarray             # float64 (n,) shared wall seconds
    duration: np.ndarray         # float64 (n,) remaining-at-start duration
    failed_until: np.ndarray     # float64 (n,)
    outage_until: np.ndarray     # float64 (n,)

    @classmethod
    def zeros(cls, n: int) -> "FleetState":
        return cls(
            has_job=np.zeros(n, bool),
            model_idx=np.zeros(n, np.int64),
            sm_share=np.zeros(n, np.float64),
            progress=np.zeros(n, np.float64),
            checkpoint=np.zeros(n, np.float64),
            started=np.zeros(n, np.float64),
            wall=np.zeros(n, np.float64),
            duration=np.zeros(n, np.float64),
            failed_until=np.full(n, -1.0, np.float64),
            outage_until=np.full(n, -1.0, np.float64),
        )


class _OfflineView(collections.abc.Mapping):
    """Lazy per-device offline-profile gather handed to
    :meth:`SharingPolicy.shared_performance` as the ``off`` mapping.

    Each key (``gpu_util``, ``sm_activity``, ``sm_occupancy``, ``mem_bw``,
    ``exec_time_ms``, ``mem_bytes_frac``) is gathered from the per-model
    constant arrays on first access and memoized, so policies that ignore
    their offline partner's profile (time-sharing, dedicated, tally) cost
    nothing here.  The engine hands in a cache dict that survives across
    ticks until a placement changes ``model_idx`` (gathers are pure
    functions of it), so steady ticks skip the gathers entirely.  A real
    Mapping, so policies written against the documented dict-like contract
    (``.get``, iteration) work too.
    """

    __slots__ = ("_arrs", "_idx", "_cache")

    def __init__(self, arrs: dict[str, np.ndarray], model_idx: np.ndarray,
                 cache: dict[str, np.ndarray] | None = None):
        self._arrs = arrs
        self._idx = model_idx
        self._cache: dict[str, np.ndarray] = ({} if cache is None
                                              else cache)

    def __getitem__(self, key: str) -> np.ndarray:
        v = self._cache.get(key)
        if v is None:
            v = self._cache[key] = self._arrs[key][self._idx]
            # cached across ticks (until the next placement): freeze so a
            # policy mutating its inputs fails loudly, not silently
            v.flags.writeable = False
        return v

    def __iter__(self):
        return iter(self._arrs)

    def __len__(self) -> int:
        return len(self._arrs)


class ClusterSim:
    """Vectorized MuxFlow cluster simulator (paper-scale capable)."""

    def __init__(self, cfg: SimConfig, predictor: SpeedPredictor | None = None,
                 *, fleet=None, hooks: SimHooks | None = None,
                 external_jobs: bool = False):
        # registry resolution raises ValueError (listing every registered
        # policy) on unknown names — a real error, not an assert, so it
        # survives ``python -O``
        self.policy = resolve_policy(cfg.policy)
        self.cfg = cfg
        self.hooks = hooks
        self.rng = np.random.default_rng(cfg.seed)
        if self.policy.needs_predictor and predictor is None:
            raise ValueError(
                f"policy {self.policy.name!r} needs a speed predictor")
        if predictor is not None and cfg.predictor_cache_quantum > 0:
            predictor = CachedSpeedPredictor(
                predictor, quantum=cfg.predictor_cache_quantum)
        self.predictor = predictor
        n = cfg.n_devices
        # per-device static attributes (same construction order as the
        # reference engine so the RNG stream is shared)
        self.qps_bank = QPSBank([OnlineQPS(self.rng) for _ in range(n)])
        self.service_idx = np.array([i % len(SERVICES) for i in range(n)],
                                    np.int64)
        if fleet is not None:
            # heterogeneous fleet: duck-typed spec with per-device gpu_type /
            # speed / hbm_gb and a pool partition
            assert len(fleet.gpu_type) == n, "fleet size != n_devices"
            self.gpu_type = list(fleet.gpu_type)
            self.speed = np.asarray(fleet.speed, np.float64)
            self.pool_of = np.asarray(fleet.pool_of, np.int64)
            self.pool_names = list(fleet.pool_names)
            hbm = np.asarray(fleet.hbm_gb, np.float64)
        else:
            self.gpu_type = [cfg.gpu_types[i % len(cfg.gpu_types)]
                             for i in range(n)]
            self.speed = np.array([1.35 if t == "A10" else 1.0
                                   for t in self.gpu_type], np.float64)
            self.pool_of = np.zeros(n, np.int64)
            self.pool_names = ["default"]
            hbm = np.full(n, DEFAULT_HBM_GB, np.float64)
        self.hbm_gb = hbm
        self.base_latency = np.array(
            [_BASE_LATENCY_MS[SERVICES[s]] for s in self.service_idx],
            np.float64)
        self.monitor = VectorSysMonitor(n, now=0.0)
        self.state = FleetState.zeros(n)
        self.job_spec: list[OfflineJobSpec | None] = [None] * n
        # offline model constants
        self.models = tuple(OFFLINE_MODEL_PROFILES)
        self.model_of = {m: i for i, m in enumerate(self.models)}
        profs = [OFFLINE_MODEL_PROFILES[m] for m in self.models]
        self.off_arrs = {
            "gpu_util": np.array([p.gpu_util for p in profs]),
            "sm_activity": np.array([p.sm_activity for p in profs]),
            "sm_occupancy": np.array([p.sm_occupancy for p in profs]),
            "mem_bw": np.array([p.mem_bw for p in profs]),
            "exec_time_ms": np.array([p.exec_time_ms for p in profs]),
            "mem_bytes_frac": np.array([p.mem_bytes_frac for p in profs]),
        }
        # xCUDA memory-quota feasibility per (pool, service, model) — memory
        # footprint fractions are profiled on a DEFAULT_HBM_GB device, so a
        # pool with more (less) HBM scales the fractions down (up)
        pool_hbm = np.array([hbm[self.pool_of == p].mean() if
                             (self.pool_of == p).any() else DEFAULT_HBM_GB
                             for p in range(len(self.pool_names))])
        self.feasible = np.array(
            [[[memory_feasible(
                self._scale_mem(online_profile(svc, 50.0), ph),
                self._scale_mem(OFFLINE_MODEL_PROFILES[m], ph),
                cfg.memory_quota)
               for m in self.models] for svc in SERVICES]
             for ph in pool_hbm])
        self.jobs = ([] if external_jobs
                     else make_trace(cfg.trace, n, cfg.horizon_s, cfg.seed))
        self.pending: list[OfflineJobSpec] = []
        self.err_handler = MixedErrorHandler(graceful_enabled=cfg.graceful_exit)
        # vectorized error-kind mapping: cumulative thresholds accumulated in
        # the exact order error_from_uniform walks them, so the mask-based
        # kind lookup is bitwise-faithful to the scalar path
        self._err_kinds = list(ERROR_MIX)
        probs = [ERROR_MIX[k] for k in self._err_kinds]
        self._err_total = sum(probs)
        acc, thresh = 0.0, []
        for p in probs:
            acc += p
            thresh.append(acc)
        self._err_thresh = np.array(thresh, np.float64)
        # per-kind handling-outcome tables, derived by probing the actual
        # §4.2 policy (a scratch handler with this run's flags) — the tick
        # cores consume only these tables, so MixedErrorHandler.handle
        # stays the single home of the propagation/graceful semantics
        probe = MixedErrorHandler(
            graceful_enabled=self.err_handler.graceful_enabled,
            detector_enabled=self.err_handler.detector_enabled)
        handled = [probe.handle(k) for k in self._err_kinds]
        self._err_propagates = np.array([h.propagated for h in handled])
        self._err_graceful_ck = np.array(
            [h.action.value == "graceful_exit" for h in handled])
        self.finished: list[tuple] = []            # (spec, jct, wall, progress)
        self.evictions = 0
        self.executions = 0
        self.errors_injected = 0
        self.online_incidents = 0
        # accumulators
        self._lat_sum = self._lat_wsum = 0.0
        self._base_lat_sum = 0.0
        self._lat_hist = np.zeros(int(_P99_MAX_MS / _P99_BIN_MS), np.int64)
        self._util_acc = np.zeros(3)
        self._util_ticks = 0
        self._tput_sum = self._tput_ticks = 0.0
        self._timeline: dict[str, list] = {"t": [], "gpu_util": [], "sm_act": [],
                                           "mem": [], "slowdown": [], "tput": []}
        # instrumentation for the scale benchmarks
        self.schedule_latencies: list[float] = []
        # optional request-level serving plane; driven from the
        # engine-agnostic accounting epilogue so both tick engines feed it
        # identical arrays
        self.serving = None
        # optional observability plane on the same epilogue seam, and an
        # opt-in wall-clock phase profiler — both None checks, zero cost
        # when disabled
        self.obs = None
        self.phases = None
        # optional chaos-plane campaign (set by a control plane; the port
        # has none yet): _schedule consults it for predictor-outage /
        # matcher-budget fallbacks; None = the byte-identical no-chaos path
        self.chaos = None
        # step-loop state (the control plane drives ticks one at a time)
        self._job_i = 0
        self._next_sched = 0.0
        self._n_injected = 0
        self._ext_mask: np.ndarray | None = None
        # shared per-tick input caches (both engines read identical values)
        from repro_torch.core.interference import online_profile_consts
        self._on_consts = online_profile_consts(self.service_idx, SERVICES)
        self._qps_memo: tuple[float, np.ndarray] | None = None
        self._gpu_type_arr = np.asarray(self.gpu_type)
        self._matcher = (IncrementalMatcher(shard_size=cfg.shard_size)
                         if cfg.incremental_matching else None)
        # per-placement-version caches of model-indexed gathers/products
        # (model_idx/sm_share change only in _start_job, which bumps
        # self.executions — the version stamp)
        self._off_cache: dict[str, np.ndarray] = {}
        self._off_cache_ver = -1
        # torch tick engine (built lazily on the first torch tick; its
        # device is resolved here, so a missing card fails at construction)
        if cfg.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {cfg.engine!r}; available: {ENGINES}")
        self.device = (resolve_device(cfg.device) if cfg.engine == "torch"
                       else None)
        self._torch = None

    def attach_serving(self, plane) -> None:
        """Attach a request-level serving plane.  Its
        ``on_tick(t, slowdown, act, outage)`` runs inside :meth:`_account`
        — after the core arrays exist, before the tick closes — so request
        accounting sees exactly what the results accounting sees."""
        self.serving = plane

    def attach_obs(self, plane) -> None:
        """Attach an observability plane (anything with
        ``on_tick(sim, inp, core)``).  Runs at the very end of
        :meth:`_account`, so rollups see the tick's final counter state.
        It must consume only the engine-agnostic per-tick arrays — the
        ``core`` dict carries post-tick ``has_job``/``mstate`` snapshots
        both engines export for exactly this purpose (live monitor/fleet
        state holds *block-end* values during torch block replay)."""
        self.obs = plane

    def attach_phases(self, profiler) -> None:
        """Attach a wall-clock phase profiler (anything with a
        ``phase(name, exclude=())`` context manager).  Its numbers never
        enter :class:`SimResults`."""
        self.phases = profiler

    @staticmethod
    def _scale_mem(profile, hbm_gb: float):
        """Rescale a profile's memory fraction to a pool's HBM size."""
        if hbm_gb == DEFAULT_HBM_GB:
            return profile
        return dataclasses.replace(
            profile, mem_bytes_frac=min(
                1.0, profile.mem_bytes_frac * DEFAULT_HBM_GB / hbm_gb))

    # ------------------------------------------------------------------ run
    def run(self) -> SimResults:
        cfg = self.cfg
        t = 0.0
        n_ticks = int(cfg.horizon_s / cfg.tick_s)
        if cfg.engine == "torch":
            # torch path: tick *blocks* run on the engine's device between
            # scheduling rounds (sparse events are
            # replayed from the kernel's stacked outputs)
            i = 0
            while i < n_ticks:
                n_block = n_ticks - i
                if self.policy.wants_scheduling:
                    # run up to the next scheduling boundary (a block whose
                    # first tick schedules extends to the boundary after
                    # it).  The boundary is found by replaying the per-tick
                    # engine's exact accumulated-float predicate
                    # (t >= next_sched) — an arithmetic shortcut (ceil of a
                    # division) lands on different ticks once tick_s is not
                    # exactly representable, silently breaking cross-engine
                    # byte-identity
                    ns = (t + cfg.schedule_interval_s
                          if t >= self._next_sched else self._next_sched)
                    n_block = 1
                    tj = t + cfg.tick_s
                    while n_block < n_ticks - i and tj < ns:
                        n_block += 1
                        tj += cfg.tick_s
                t = self._step_block(t, n_block)
                i += n_block
            return self._results(t)
        for _ in range(n_ticks):
            t = self.step(t)
        return self._results(t)

    def step(self, t: float) -> float:
        """Advance the engine one tick from time ``t``; returns the next tick
        time.  External drivers (a control plane) call
        this directly and interleave their own work between ticks."""
        return self._step_block(t, 1)

    def _step_block(self, t: float, n_block: int) -> float:
        """Advance ``n_block`` ticks; scheduling may only occur at the first
        tick of a block (callers align blocks to scheduling boundaries)."""
        cfg = self.cfg
        while (self._job_i < len(self.jobs)
               and self.jobs[self._job_i].submit_s <= t):
            self.pending.append(self.jobs[self._job_i])
            self._job_i += 1
        if self.policy.wants_scheduling and t >= self._next_sched:
            t0 = time.perf_counter()
            n_free, n_before = self._schedule(t)
            wall = time.perf_counter() - t0
            self.schedule_latencies.append(wall)
            if self.hooks is not None:
                self.hooks.on_schedule(self, t, n_free, n_before,
                                       n_before - len(self.pending), wall)
            self._next_sched = t + cfg.schedule_interval_s
        if n_block == 1:
            self._tick(t)
            return t + cfg.tick_s
        # multi-tick block: batch job arrivals tick-exactly (nothing reads
        # the pending queue until the next scheduling boundary)
        ts = [t]
        for _ in range(n_block - 1):
            ts.append(ts[-1] + cfg.tick_s)
        for tj in ts[1:]:
            while (self._job_i < len(self.jobs)
                   and self.jobs[self._job_i].submit_s <= tj):
                self.pending.append(self.jobs[self._job_i])
                self._job_i += 1
        self._tick_block(ts)
        return ts[-1] + cfg.tick_s

    # ------------------------------------------------- control-plane surface
    def inject_jobs(self, specs: list[OfflineJobSpec]) -> None:
        """Mid-run job submission (the control plane's JobManager path):
        specs join the pending queue immediately and count toward n_jobs."""
        self._n_injected += len(specs)
        self.pending.extend(specs)

    def force_error(self, i: int, t: float, kind):
        """Inject a specific :class:`~repro_torch.core.errors.ErrorKind` on busy
        device ``i`` (fault-campaign entry point).  Routes through the mixed
        error handler exactly like the engine's own error process; returns
        the :class:`HandledError`, or None if the device has no offline job."""
        if not self.state.has_job[i]:
            return None
        requeues: list[tuple[int, OfflineJobSpec]] = []
        handled = self._handle_error(i, t, kind, requeues)
        if requeues:
            self.pending[:0] = [spec for _, spec in reversed(requeues)]
        return handled

    def evict_device(self, i: int, t: float, reason: str = "external",
                     count: bool = True) -> None:
        """Evict the offline job on device ``i`` (if any), requeueing it from
        its last checkpoint.  Used by autoscaler scale-ups and fault
        campaigns between ticks."""
        requeues: list[tuple[int, OfflineJobSpec]] = []
        self._evict(i, t, requeues, reason=reason, count=count)
        if requeues:
            self.pending[:0] = [spec for _, spec in reversed(requeues)]

    def set_schedulable_mask(self, mask: np.ndarray | None) -> None:
        """Extra per-device schedulability constraint ANDed into every
        scheduling round (e.g. node-agent heartbeat staleness).  Pass None to
        clear."""
        self._ext_mask = mask

    def pool_view(self, t: float) -> list[dict]:
        """Per-pool state snapshot (counts + load) for the control plane."""
        s = self.state
        alive = s.failed_until <= t
        qps = self.qps_bank.qps(t)
        sched = self.monitor.schedulable
        views = []
        for p, name in enumerate(self.pool_names):
            m = self.pool_of == p
            busy = m & s.has_job
            views.append({
                "pool": name,
                "n": int(m.sum()),
                "alive": int((m & alive).sum()),
                "busy": int(busy.sum()),
                "schedulable": int((m & sched).sum()),
                "mean_sm_share": (float(s.sm_share[busy].mean())
                                  if busy.any() else 0.0),
                "qps_sum": float(qps[m].sum()),
                "hbm_gb": float(self.hbm_gb[m].mean()) if m.any() else 0.0,
            })
        return views

    def finalize(self, t_end: float) -> SimResults:
        """Aggregate results after an externally driven step loop."""
        return self._results(t_end)

    # ------------------------------------------------------------- schedule
    def _schedule(self, t: float) -> tuple[int, int]:
        """One scheduling round; returns (n_free, n_pending_before)."""
        cfg = self.cfg
        s = self.state
        n_before = len(self.pending)
        sched_cfg = self.policy.scheduler_config(shard_size=cfg.shard_size)
        if sched_cfg is None:
            # greedy FIFO packing: any alive device without a job, SM share
            # handed out by the policy
            ok = ~s.has_job & (s.failed_until <= t)
            if self._ext_mask is not None:
                ok &= self._ext_mask
            free = np.flatnonzero(ok)
            take = free[:len(self.pending)]
            if take.size:
                qps = self.tick_qps(t)
                on = online_profile_arrays(self.service_idx, qps, SERVICES,
                                           consts=self._on_consts)
                shares = self.policy.sm_shares(on, take)
                for k, i in enumerate(take):
                    self._start_job(int(i), self.pending.pop(0),
                                    float(shares[k]), t)
            return int(free.size), n_before
        if not self.pending:
            return 0, n_before
        # free healthy devices (the paper only schedules onto Healthy GPUs)
        ok = ~s.has_job & (s.failed_until <= t) & self.monitor.schedulable
        if self._ext_mask is not None:
            ok &= self._ext_mask
        free = np.flatnonzero(ok)
        if free.size == 0:
            return 0, n_before
        qps = self.tick_qps(t)
        on = online_profile_arrays(self.service_idx, qps, SERVICES,
                                   consts=self._on_consts)
        jobs = [OfflineJob(sp.job_id, OFFLINE_MODEL_PROFILES[sp.model],
                           sp.duration_s) for sp in self.pending]
        # array-native Algorithm 1: weight grid without per-slot objects,
        # matching warm-started from the previous round's clean shards
        if sched_cfg.use_dynamic_sm:
            shares = dynamic_sm_array(on["sm_activity"][free])
        else:
            shares = np.full(free.size, fixed_sm(sched_cfg.fixed_sm_share),
                             np.float64)
        on_feats = np.stack(
            [on["gpu_util"][free], on["sm_activity"][free],
             on["sm_occupancy"][free], on["exec_time_ms"][free] / 1000.0],
            axis=1).astype(np.float32)
        ph = self.phases
        chaos = self.chaos

        def _grid():
            # degradation ladder: during a predictor outage the round runs
            # on the §4.3 static share table — no predictor call at all
            if chaos is not None and chaos.predictor_down(t):
                chaos.note_predictor_fallback(t)
                return static_weight_grid(shares, jobs, sched_cfg)
            return build_weight_grid_arrays(
                self._gpu_type_arr[free], on_feats, shares, jobs,
                self.predictor, sched_cfg)

        def _pairs(values, col_group):
            # degradation ladder: an exhausted matching time budget falls
            # back to greedy-FIFO placement (the MuxFlow-M ablation path)
            if chaos is not None and chaos.matcher_exhausted(t):
                chaos.note_matcher_fallback(t, free.size, len(jobs))
                greedy = dataclasses.replace(sched_cfg, use_matching=False)
                return solve_matching(values, col_group, greedy)
            return solve_matching(values, col_group, sched_cfg,
                                  row_ids=free, matcher=self._matcher)

        # _schedule runs in plain Python on both tick engines, so the
        # chaos consults above are engine-invariant by construction
        if ph is None:
            values, col_group = _grid()
            pairs = _pairs(values, col_group)
        else:
            with ph.phase("predict"):
                values, col_group = _grid()
            with ph.phase("match"):
                pairs = _pairs(values, col_group)
        by_job = {sp.job_id: sp for sp in self.pending}
        assigned: set[int] = set()
        for i, j in pairs:
            device_id = int(free[i])
            job_id = jobs[j].job_id
            spec = by_job.get(job_id)
            if spec is None or job_id in assigned:
                continue
            if not self.feasible[self.pool_of[device_id],
                                 self.service_idx[device_id],
                                 self.model_of[spec.model]]:
                continue  # xCUDA memory quota rejects the pairing
            assigned.add(job_id)
            self._start_job(device_id, spec, float(shares[i]), t)
        if assigned:
            self.pending = [sp for sp in self.pending
                            if sp.job_id not in assigned]
        return int(free.size), n_before

    def _start_job(self, i: int, spec: OfflineJobSpec, share: float,
                   t: float) -> None:
        s = self.state
        s.has_job[i] = True
        s.model_idx[i] = self.model_of[spec.model]
        s.sm_share[i] = share
        s.progress[i] = 0.0
        s.checkpoint[i] = 0.0
        s.started[i] = t
        s.wall[i] = 0.0
        s.duration[i] = spec.duration_s
        self.job_spec[i] = spec
        self.executions += 1
        if self.hooks is not None:
            self.hooks.on_job_start(self, t, i, spec, share)

    # ----------------------------------------------------------------- tick
    def tick_qps(self, t: float) -> np.ndarray:
        """Fleet QPS at tick time ``t``, memoized — the tick engine, the
        scheduler, and the control plane's autoscaler all read one row."""
        memo = self._qps_memo
        if memo is not None and memo[0] == t:
            return memo[1]
        row = self.qps_bank.qps(t)
        self._qps_memo = (t, row)
        return row

    def _tick_inputs(self, t: float) -> dict:
        """The tick's dense inputs: one (3, n) uniform block (the shared RNG
        contract `repro`'s engines share: rows are hw-failure, error,
        error-kind), the trace/profile arrays, and the policy's vectorized
        shared-performance surfaces.  Both tick cores consume these verbatim,
        so their inputs are bitwise-identical by construction."""
        s = self.state
        fail_u, err_u, kind_u = self.rng.random((3, self.cfg.n_devices))
        qps = self.tick_qps(t)
        on = online_profile_arrays(self.service_idx, qps, SERVICES,
                                   consts=self._on_consts)
        # gathers/products below are pure functions of (model_idx, sm_share)
        # which only _start_job changes (version-stamped by `executions`) —
        # steady ticks reuse them outright
        if self._off_cache_ver != self.executions:
            self._off_cache = {}
            self._off_cache_ver = self.executions
        off = _OfflineView(self.off_arrs, s.model_idx, cache=self._off_cache)
        slow_raw, tput_raw = self.policy.shared_performance(on, off,
                                                           s.sm_share)
        tput_speed = tput_raw * self.speed
        prods = self._off_cache.get("_products")
        if prods is None:
            # telemetry products precomputed host-side: the torch tick
            # core may contain no multiply that feeds an add/sub (a
            # compiler would be free to contract it into an FMA, breaking
            # bitwise engine parity), so every such product is formed here
            # and only *added* in the cores
            used_min = np.minimum(s.sm_share, off["sm_activity"])
            prods = (used_min, 0.62 * used_min, 0.45 * used_min,
                     off["mem_bytes_frac"])
            for arr in prods[:3]:
                arr.flags.writeable = False      # cached across ticks
            self._off_cache["_products"] = prods
        used_min, used62, used45, off_mem = prods
        return dict(t=t, qps=qps, on=on, fail_u=fail_u, err_u=err_u,
                    kind_u=kind_u, slow_raw=slow_raw, tput_speed=tput_speed,
                    tput_dt=tput_speed * self.cfg.tick_s,
                    used_min=used_min, used62=used62, used45=used45,
                    off_mem=off_mem)

    def _dense_core_numpy(self, inp: dict) -> dict:
        """One tick of dense per-device state evolution — the reference
        implementation of the tick core.  ``core/engine_torch.py`` runs the
        exact same operations; a fixed-seed test pins the two cores to
        bitwise-identical outputs.  Mutates fleet/monitor state and returns
        the per-tick arrays the (engine-agnostic) accounting pass consumes.
        """
        cfg = self.cfg
        s = self.state
        t = inp["t"]
        dt = cfg.tick_s
        on = inp["on"]
        alive = s.failed_until <= t
        new_fail = alive & (inp["fail_u"] < dt / (cfg.device_mtbf_h * 3600.0))
        s.failed_until = np.where(new_fail, t + cfg.device_repair_s,
                                  s.failed_until)
        act = alive & ~new_fail
        busy = act & s.has_job
        has_job = s.has_job & ~new_fail
        slowdown = np.where(busy, inp["slow_raw"], 1.0)
        tput = np.where(busy, inp["tput_speed"], 0.0)
        # offline progress + periodic checkpoint
        s.progress = np.where(busy, s.progress + inp["tput_dt"], s.progress)
        s.wall = np.where(busy, s.wall + dt, s.wall)
        ck = busy & (s.progress - s.checkpoint >= cfg.checkpoint_interval_s)
        s.checkpoint = np.where(ck, s.progress, s.checkpoint)
        # error injection (offline container errors): kind + handling
        # outcome are pure functions of the uniforms — outcome via the
        # per-kind tables probed from MixedErrorHandler (see __init__)
        p_err = cfg.error_rate_per_job_hour * dt / 3600.0
        err = busy & (inp["err_u"] < p_err)
        # kind_idx is only meaningful where err is set (the torch core
        # computes the full array; the contract is mask-scoped)
        kind_idx = np.zeros(cfg.n_devices, np.int64)
        ei = np.flatnonzero(err)
        if ei.size:
            r = inp["kind_u"][ei] * self._err_total
            kind_idx[ei] = np.minimum(
                (r[:, None] > self._err_thresh[None, :]).sum(axis=1),
                len(self._err_kinds) - 1)
        propagated = err & self._err_propagates[kind_idx]
        s.outage_until = np.where(propagated, t + cfg.online_outage_s,
                                  s.outage_until)
        # graceful exit checkpoints before releasing
        s.checkpoint = np.where(err & self._err_graceful_ck[kind_idx],
                                s.progress, s.checkpoint)
        has_job = has_job & ~err
        # job completion (error-evicted devices dropped has_job already)
        fin = busy & has_job & (s.progress >= s.duration)
        has_job = has_job & ~fin
        # telemetry + SysMonitor.  Each expression is written so no product
        # directly feeds an add/sub (see _tick_inputs): ``c·used_off`` terms
        # use the host-precomputed products masked by has_job (bitwise equal
        # to scaling after masking, since c·0 == 0), and the clock scales
        # inside the max (bitwise equal: 420·max(0, z) == max(0, 420·z))
        used_off = np.where(has_job, inp["used_min"], 0.0)
        tele_util = np.minimum(
            1.0, on["gpu_util"] + np.where(has_job, inp["used62"], 0.0))
        tele_sm = np.minimum(
            1.0, on["sm_activity"] + np.where(has_job, inp["used45"], 0.0))
        tele_clock = 1590.0 - np.maximum(
            0.0, 420.0 * (on["sm_activity"] + used_off - 0.8))
        tele_mem = np.minimum(
            1.0, on["mem_bytes_frac"] + np.where(has_job, inp["off_mem"],
                                                 0.0))
        level = self.monitor.classify(tele_util, tele_sm, tele_mem,
                                      tele_clock, 60.0)
        evict_ev = self.monitor.update(level, t, active=act)
        evict_cand = evict_ev & has_job
        s.has_job = has_job & ~evict_cand
        # has_job/mstate: post-tick snapshots for the obs rollups — part of
        # the cross-engine core contract (the torch engine exports its
        # per-tick copies; live state would hold block-end values)
        return dict(new_fail=new_fail, err=err, kind_idx=kind_idx, fin=fin,
                    evict_cand=evict_cand, busy=busy, act=act,
                    slowdown=slowdown, tput=tput, tele_util=tele_util,
                    tele_sm=tele_sm, tele_clock=tele_clock, tele_mem=tele_mem,
                    level=level, progress=s.progress, wall=s.wall,
                    checkpoint=s.checkpoint, outage_until=s.outage_until,
                    has_job=s.has_job, mstate=self.monitor.state)

    def _account(self, inp: dict, core: dict) -> None:
        """The engine-agnostic tick epilogue: sparse event bookkeeping
        (hooks, requeues, counters) and every reduction that lands in
        :class:`SimResults`.  Runs in numpy for both engines, on core output
        arrays that are bitwise-identical between them — so results and
        event streams cannot drift across engines."""
        cfg = self.cfg
        t = inp["t"]
        n = cfg.n_devices
        progress, wall = core["progress"], core["wall"]
        checkpoint = core["checkpoint"]
        requeues: list[tuple[int, OfflineJobSpec]] = []
        for i in np.flatnonzero(core["new_fail"]):
            i = int(i)
            if self.hooks is not None:
                self.hooks.on_device_fail(self, t, i,
                                          t + cfg.device_repair_s)
            self._record_evict(i, t, requeues, reason="device_failure",
                               count=False, progress=float(progress[i]),
                               checkpoint=float(checkpoint[i]))
        for i in np.flatnonzero(core["err"]):
            i = int(i)
            kind = self._err_kinds[int(core["kind_idx"][i])]
            self.errors_injected += 1
            handled = self.err_handler.handle(kind)
            if handled.propagated:
                self.online_incidents += 1
            if self.hooks is not None:
                self.hooks.on_error(self, t, i, handled)
            self._record_evict(i, t, requeues, reason="error", count=False,
                               progress=float(progress[i]),
                               checkpoint=float(checkpoint[i]))
        for i in np.flatnonzero(core["fin"]):
            i = int(i)
            spec = self.job_spec[i]
            self.finished.append((spec, t - spec.submit_s,
                                  float(wall[i]), float(progress[i])))
            self.job_spec[i] = None
            if self.hooks is not None:
                self.hooks.on_job_finish(self, t, i, spec,
                                         t - spec.submit_s, float(wall[i]),
                                         float(progress[i]))
        for i in np.flatnonzero(core["evict_cand"]):
            i = int(i)
            self._record_evict(i, t, requeues, reason="overlimit",
                               count=True, progress=float(progress[i]),
                               checkpoint=float(checkpoint[i]))
        # requeues resume from checkpoint, at the head of the queue in
        # reverse device order
        if requeues:
            requeues.sort(key=lambda e: e[0])
            self.pending[:0] = [spec for _, spec in reversed(requeues)]
        # online latency accounting (weighted by qps)
        act, busy = core["act"], core["busy"]
        slowdown, tput = core["slowdown"], core["tput"]
        tput_n = int(busy.sum())
        tput_sum = float(tput[busy].sum())
        outage = core["outage_until"] > t
        if self.serving is not None:
            if self.phases is None:
                self.serving.on_tick(t, slowdown, act, outage)
            else:
                with self.phases.phase("serving"):
                    self.serving.on_tick(t, slowdown, act, outage)
        lat = self.base_latency * slowdown * np.where(outage, 10.0, 1.0)
        lat_a, qps_a = lat[act], inp["qps"][act]
        self._lat_sum += float((lat_a * qps_a).sum())
        self._base_lat_sum += float((self.base_latency[act] * qps_a).sum())
        self._lat_wsum += float(qps_a.sum())
        np.add.at(self._lat_hist,
                  np.minimum((lat_a / _P99_BIN_MS).astype(np.int64),
                             self._lat_hist.size - 1), 1)
        tele_util, tele_sm = core["tele_util"], core["tele_sm"]
        tele_mem = core["tele_mem"]
        util = np.array([tele_util[act].sum(), tele_sm[act].sum(),
                         tele_mem[act].sum()])
        self._util_acc += util
        self._util_ticks += 1
        if tput_n:
            self._tput_sum += tput_sum / tput_n
            self._tput_ticks += 1
        if self.hooks is not None:
            self.hooks.on_tick_end(self, t, {
                "qps": inp["qps"], "gpu_util": tele_util,
                "sm_activity": tele_sm, "mem_used": tele_mem,
                "sm_clock": core["tele_clock"], "level": core["level"],
                "busy": busy, "active": act, "slowdown": slowdown,
                "tput": tput})
        if int(t) % 600 == 0:
            slow_n = int(act.sum())
            self._timeline["t"].append(t)
            self._timeline["gpu_util"].append(util[0] / max(n, 1))
            self._timeline["sm_act"].append(util[1] / max(n, 1))
            self._timeline["mem"].append(util[2] / max(n, 1))
            self._timeline["slowdown"].append(
                float(slowdown[act].sum()) / max(slow_n, 1))
            self._timeline["tput"].append(
                tput_sum / max(tput_n, 1) if tput_n else 0.0)
        if self.obs is not None:
            self.obs.on_tick(self, inp, core)

    def _tick(self, t: float) -> None:
        ph = self.phases
        if ph is None:
            inp = self._tick_inputs(t)
            if self.cfg.engine == "torch":
                core = self._torch_engine().tick(inp)
            else:
                core = self._dense_core_numpy(inp)
            self._account(inp, core)
            return
        with ph.phase("inputs"):
            inp = self._tick_inputs(t)
        with ph.phase("dense_core"):
            core = (self._torch_engine().tick(inp)
                    if self.cfg.engine == "torch"
                    else self._dense_core_numpy(inp))
        with ph.phase("account", exclude=("serving",)):
            self._account(inp, core)

    def _tick_block(self, ts: list[float]) -> None:
        """A scheduling-free run of consecutive ticks.  The torch engine runs
        the whole block on its device with one copy back, and the accounting
        pass replays each tick from the stacked outputs; the numpy engine
        simply ticks."""
        if self.cfg.engine != "torch":
            for t in ts:
                self._tick(t)
            return
        ph = self.phases
        if ph is None:
            inps = [self._tick_inputs(t) for t in ts]
            for inp, core in zip(inps, self._torch_engine().tick_block(inps)):
                self._account(inp, core)
            return
        with ph.phase("inputs"):
            inps = [self._tick_inputs(t) for t in ts]
        with ph.phase("dense_core"):
            cores = self._torch_engine().tick_block(inps)
        with ph.phase("account", exclude=("serving",)):
            for inp, core in zip(inps, cores):
                self._account(inp, core)

    def _torch_engine(self):
        if self._torch is None:
            from repro_torch.core.engine_torch import TorchTickEngine
            self._torch = TorchTickEngine(self, self.device)
        return self._torch

    def _handle_error(self, i: int, t: float, kind, requeues: list):
        """One offline-container error on device ``i`` — the *between-tick*
        path (``force_error``/fault campaigns).  In-tick errors evolve
        state inside the dense cores via the per-kind outcome tables
        probed from :class:`MixedErrorHandler` in ``__init__`` (handler
        semantics have one home) and book-keep through the same
        ``err_handler.handle`` call in ``_account``, so the two paths'
        injected/propagated accounting cannot drift."""
        self.errors_injected += 1
        handled = self.err_handler.handle(kind)
        if handled.propagated:
            self.state.outage_until[i] = t + self.cfg.online_outage_s
            self.online_incidents += 1
        if handled.action.value == "graceful_exit":
            # graceful exit checkpoints before releasing
            self.state.checkpoint[i] = self.state.progress[i]
        if self.hooks is not None:
            self.hooks.on_error(self, t, i, handled)
        self._evict(i, t, requeues, reason="error", count=False)
        return handled

    def _evict(self, i: int, t: float, requeues: list, *,
               reason: str = "overlimit", count: bool = True) -> None:
        """Mutating eviction — the between-tick path (autoscaler, fault
        campaigns, external callers).  In-tick evictions clear state inside
        the dense core and only book-keep via :meth:`_record_evict`."""
        s = self.state
        if not s.has_job[i]:
            return
        s.has_job[i] = False
        self._record_evict(i, t, requeues, reason=reason, count=count,
                           progress=float(s.progress[i]),
                           checkpoint=float(s.checkpoint[i]))

    def _record_evict(self, i: int, t: float, requeues: list, *,
                      reason: str, count: bool, progress: float,
                      checkpoint: float) -> None:
        """Eviction bookkeeping: counters, requeue from checkpoint, hook."""
        spec = self.job_spec[i]
        if spec is None:
            return
        if count:
            self.evictions += 1
        self.job_spec[i] = None
        requeued = progress < spec.duration_s
        if requeued:
            # resume from last checkpoint
            requeues.append((i, dataclasses.replace(
                spec, duration_s=spec.duration_s - checkpoint)))
        if self.hooks is not None:
            self.hooks.on_job_evict(self, t, i, spec, reason, progress,
                                    checkpoint, requeued)

    # -------------------------------------------------------------- results
    def _results(self, t_end: float) -> SimResults:
        s = self.state
        r = SimResults(policy=self.policy.name, trace=self.cfg.trace)
        r.n_jobs = len(self.jobs) + self._n_injected
        r.n_finished = len(self.finished)
        if self.finished:
            r.avg_jct_s = float(np.mean([jct for _, jct, _, _ in self.finished]))
            r.makespan_s = float(max(jct + sp.submit_s
                                     for sp, jct, _, _ in self.finished))
        r.avg_latency_ms = self._lat_sum / max(self._lat_wsum, 1e-9)
        r.base_avg_latency_ms = self._base_lat_sum / max(self._lat_wsum, 1e-9)
        r.avg_slowdown = r.avg_latency_ms / max(r.base_avg_latency_ms, 1e-9)
        total = int(self._lat_hist.sum())
        if total:
            k = int(np.searchsorted(np.cumsum(self._lat_hist),
                                    np.ceil(0.99 * total)))
            r.p99_latency_ms = (k + 1) * _P99_BIN_MS
        util = self._util_acc / max(self._util_ticks * self.cfg.n_devices, 1)
        r.gpu_util, r.sm_activity, r.mem_used = map(float, util)
        r.avg_norm_tput = self._tput_sum / max(self._tput_ticks, 1e-9)
        # Eq. 3: oversold GPU — effective separate-execution seconds delivered
        # per wall-second the offline workloads spent sharing a device
        prog = float(s.progress[s.has_job].sum())
        wall = float(s.wall[s.has_job].sum())
        prog += sum(p for _, _, _, p in self.finished)
        wall += sum(w for _, _, w, _ in self.finished)
        r.oversold_gpu = float(min(1.0, prog / max(wall, 1e-9)))
        r.evictions = self.evictions
        r.eviction_frac = self.evictions / max(self.executions, 1)
        r.errors_injected = self.errors_injected
        r.errors_propagated = sum(1 for h in self.err_handler.handled
                                  if h.propagated)
        r.online_incidents = self.online_incidents
        r.timeline = self._timeline
        return r


def build_sim_config(policy: str | SharingPolicy,
                     **overrides) -> tuple[SimConfig, SharingPolicy]:
    """The one shared config-resolution path for every ``run_policy*``
    entry point (this module's and the control plane's): the policy resolves
    through the registry here — unknown names raise ``ValueError`` listing
    every registered policy — and lands in the config as the resolved
    object, so policy validation cannot drift between entry points.
    (Predictor validation has a single home too: ``ClusterSim.__init__``.)
    """
    pol = resolve_policy(policy)
    return SimConfig(policy=pol, **overrides), pol


def run_policy(policy: str | SharingPolicy,
               predictor: SpeedPredictor | None = None,
               **overrides) -> SimResults:
    cfg, _ = build_sim_config(policy, **overrides)
    return ClusterSim(cfg, predictor).run()
