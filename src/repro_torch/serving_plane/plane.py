"""The request-level serving plane: per-service queues on the sim tick clock.

Each online service gets a *lane*: an :class:`ArrivalProcess` feeding a FIFO
request queue that is drained by continuous batching against the fleet
capacity the simulator's own telemetry implies each tick.  Requests are
accounted enqueue → start → finish:

* **enqueue** — arrivals land as sub-tick cohorts (``subcohorts`` equal
  slices per tick, each stamped at its slice midpoint), optionally carrying
  a Philly-style skewed per-request size multiplier (mean-1 lognormal);
* **start** — the admission policy sheds SLO-doomed requests first, then
  FIFO capacity ``C_s(t) · tick_s`` drains the queue.  Capacity is derived
  from the engine's byte-identical per-tick arrays: active, non-outage
  devices of the service contribute ``qps_capacity × speed / slowdown``
  requests per second, so interference, faults, agent staleness, and
  autoscaling all move user-visible latency;
* **finish** — a served cohort's latency is its queueing delay (backlog
  ahead of it over this tick's capacity, floored at its own arrival time)
  plus the service time (base latency × the service's mean slowdown — the
  simulator's own latency model).  Latencies land in a fixed-bin histogram
  per service, from which p50/p99, SLO attainment, and means are derived.

Determinism: lanes draw arrival counts and size multipliers from dedicated
``SeedSequence`` streams in tick order, and consume only engine arrays that
are bitwise-identical across the numpy and torch tick engines — so the
``"serving"`` report section is byte-identical across processes and across
engines (CI ``cmp``s both).

Copied from `repro/serving_plane/plane.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.interference import ONLINE_SERVICE_PROFILES
from repro_torch.core.traces import SERVICES, philly_request_times
from repro_torch.serving_plane.admission import resolve_admission
from repro_torch.serving_plane.arrivals import ARRIVAL_KINDS, ArrivalProcess, _rng

SERVING_SCHEMA = "repro.serving/v1"

_BIN_MS = 0.5                  # latency histogram resolution
_MAX_MS = 600_000.0            # 10 min clip (overflow lands in the last bin)
_N_BINS = int(_MAX_MS / _BIN_MS)
# per-metrics-window histogram: coarser bins keep the reset cheap while a
# 4 ms-quantized p99 is plenty for burn-rate alerting
_WIN_BIN_MS = 4.0
_WIN_BINS = int(_MAX_MS / _WIN_BIN_MS)
# trace-replay materializes timestamps; refuse silly sizes instead of OOMing
_MAX_TRACE_REQUESTS = 3_000_000


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Declarative serving-plane spec (a :class:`Scenario` field).

    ``load`` targets mean utilization against the fleet's *nominal*
    capacity (``qps_capacity × speed`` summed per service); the arrival
    kind shapes it over time.  ``slo_latency_mult`` sets each service's SLO
    to that multiple of its base latency unless ``slo_ms`` pins an explicit
    value.  ``request_size_sigma > 0`` draws mean-1 lognormal per-cohort
    request-size multipliers (Philly-style skew: most requests small, a
    heavy tail 2–5× the mean).
    """
    arrivals: str = "diurnal"            # an ARRIVAL_KINDS member
    load: float = 0.7
    rate_rps: float | None = None        # explicit fleet-total rate override
    slo_latency_mult: float = 6.0
    slo_ms: tuple = ()                   # (("vision", 400.0), ...) overrides
    admission: str = "deadline"
    admission_slack: float = 1.0
    request_size_sigma: float = 0.0
    subcohorts: int = 4
    burst_mult: float = 3.0
    burst_period_s: float = 3600.0
    burst_len_s: float = 300.0

    def __post_init__(self):
        if self.arrivals not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival kind {self.arrivals!r}; "
                             f"available: {ARRIVAL_KINDS}")
        if not 0 < self.load:
            raise ValueError(f"load must be positive, got {self.load}")
        if self.subcohorts < 1:
            raise ValueError("subcohorts must be >= 1")


class _Lane:
    """One service's queue, histogram, and counters."""

    def __init__(self, service: str, idx: np.ndarray, speed: np.ndarray,
                 process: ArrivalProcess,
                 admission, *, slo_ms: float, base_latency_ms: float,
                 qps_capacity: float, size_rng, sigma: float, sub: int):
        self.service = service
        self.idx = idx                       # device indices of this service
        self.speed = speed                   # per-device speed grade
        self.process = process
        self.admission = admission
        self.slo_ms = slo_ms
        self.base_latency_ms = base_latency_ms
        self.qps_capacity = qps_capacity
        self.size_rng = size_rng
        self.sigma = sigma
        self.sub = sub
        # queue of [t_arr, n_requests, work_per_request]
        self.queue: deque[list] = deque()
        self.hist = np.zeros(_N_BINS, np.int64)
        self.arrived = self.served = self.shed = 0
        self.within_slo = 0
        # chaos ladder: requests dropped by tiered brownout (a subset of
        # `shed`; surfaced in the report's "resilience" section)
        self.brownout_shed = 0
        # per-metrics-window counters (reset by window_snapshot)
        self.win_hist = np.zeros(_WIN_BINS, np.int64)
        self.win_arrived = self.win_served = self.win_shed = 0
        self.win_within = 0
        self.lat_sum_ms = 0.0
        self.max_ms = 0.0
        self.peak_queue = 0
        self.cap_sum = 0.0
        self.ticks = 0
        # optional request tracer (an observability plane's) + batch ids
        self.tracer = None
        self._batch_seq = 0

    # ------------------------------------------------------------- per-tick
    def step(self, t: float, dt: float, capacity_rps: float,
             service_ms: float, *, demand_mult: float = 1.0,
             brownout_frac: float = 0.0) -> None:
        self.ticks += 1
        self.cap_sum += capacity_rps
        # enqueue: sub-tick cohorts at slice midpoints, skewed sizes.
        # A chaos overload burst multiplies demand AFTER the arrival draw,
        # so the lane's RNG stream is identical with and without chaos.
        n_new = self.process.counts_at(t, dt)
        if demand_mult != 1.0:
            n_new = int(round(n_new * demand_mult))
        if n_new > 0:
            self.arrived += n_new
            self.win_arrived += n_new
            work = 1.0
            if self.sigma > 0:
                work = float(self.size_rng.lognormal(
                    -0.5 * self.sigma * self.sigma, self.sigma))
            base, extra = divmod(n_new, self.sub)
            for j in range(self.sub):
                n_j = base + (1 if j < extra else 0)
                if n_j:
                    t_arr = t + (j + 0.5) * dt / self.sub
                    self.queue.append([t_arr, n_j, work])
        q_len = sum(c[1] for c in self.queue)
        self.peak_queue = max(self.peak_queue, q_len)
        # chaos ladder: tiered brownout sheds the oldest queued fraction
        # before admission/drain burn capacity on doomed work
        if brownout_frac > 0.0 and q_len:
            self._brownout(t, q_len, brownout_frac)
        service_s = service_ms / 1e3
        # admission: shed SLO-doomed requests before burning capacity
        if self.queue:
            ages = np.array([t - c[0] for c in self.queue])
            counts = np.array([c[1] for c in self.queue])
            sheds = np.minimum(
                self.admission.shed(t, ages, counts,
                                    slo_s=self.slo_ms / 1e3,
                                    service_s=service_s,
                                    capacity_rps=capacity_rps),
                counts)
            if sheds.any():
                for c, k in zip(list(self.queue), sheds):
                    c[1] -= int(k)
                    if self.tracer is not None and k:
                        self.tracer.shed(self.service, t, c[0], int(k))
                self.shed += int(sheds.sum())
                self.win_shed += int(sheds.sum())
                while self.queue and self.queue[0][1] == 0:
                    self.queue.popleft()
        # continuous batching: FIFO drain of K = C·dt request-work units
        if capacity_rps <= 0 or not self.queue:
            return
        budget = capacity_rps * dt
        cum = 0.0
        while self.queue and budget > 1e-12:
            t_arr, n, work = self.queue[0]
            n_fit = int(min(n, (budget + 1e-9) // work))
            if n_fit <= 0:
                break
            # finish when the backlog ahead (+ half this batch) drains,
            # never before the requests actually arrived
            finish = t + (cum + n_fit * work * 0.5) / capacity_rps
            wait_s = max(finish, t_arr) - t_arr
            lat_ms = wait_s * 1e3 + service_ms
            self._record(lat_ms, n_fit)
            if self.tracer is not None:
                self._batch_seq += 1
                self.tracer.batch(self.service, self._batch_seq, t, t_arr,
                                  n_fit, work, wait_s * 1e3, service_ms,
                                  lat_ms)
            cum += n_fit * work
            budget -= n_fit * work
            if n_fit == n:
                self.queue.popleft()
            else:
                self.queue[0][1] = n - n_fit
                break

    def _brownout(self, t: float, q_len: int, frac: float) -> None:
        """Shed ``frac`` of the queue oldest-first (tiered brownout)."""
        target = int(q_len * frac)
        shed = 0
        while target > 0 and self.queue:
            c = self.queue[0]
            k = min(c[1], target)
            c[1] -= k
            target -= k
            shed += k
            if self.tracer is not None:
                self.tracer.shed(self.service, t, c[0], k)
            if c[1] == 0:
                self.queue.popleft()
        if shed:
            self.shed += shed
            self.win_shed += shed
            self.brownout_shed += shed

    def _record(self, lat_ms: float, n: int) -> None:
        self.served += n
        self.win_served += n
        self.lat_sum_ms += lat_ms * n
        self.max_ms = max(self.max_ms, lat_ms)
        if lat_ms <= self.slo_ms:
            self.within_slo += n
            self.win_within += n
        self.hist[min(int(lat_ms / _BIN_MS), _N_BINS - 1)] += n
        self.win_hist[min(int(lat_ms / _WIN_BIN_MS), _WIN_BINS - 1)] += n

    def window_snapshot(self) -> dict:
        """Per-window counters + coarse p99 for the metrics-window rollup
        and the alert engine's attainment/burn-rate feed; resets the
        window.  Driven by the metrics recorder at window boundaries."""
        snap = {"arrived": self.win_arrived, "served": self.win_served,
                "shed": self.win_shed, "within_slo": self.win_within,
                "p99_ms": _percentile(self.win_hist, 0.99, _WIN_BIN_MS)}
        self.win_arrived = self.win_served = self.win_shed = 0
        self.win_within = 0
        self.win_hist[:] = 0
        return snap

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        done = self.served + self.shed      # requests with a known outcome
        return {
            "arrived": int(self.arrived),
            "served": int(self.served),
            "shed": int(self.shed),
            "queued_end": int(sum(c[1] for c in self.queue)),
            "slo_ms": round(self.slo_ms, 3),
            "p50_ms": _percentile(self.hist, 0.50),
            "p99_ms": _percentile(self.hist, 0.99),
            "mean_ms": (round(self.lat_sum_ms / self.served, 4)
                        if self.served else 0.0),
            "max_ms": round(self.max_ms, 4),
            # shed requests definitionally miss their SLO
            "slo_attainment": (round(self.within_slo / done, 6)
                               if done else 1.0),
            "peak_queue": int(self.peak_queue),
            "mean_capacity_rps": (round(self.cap_sum / self.ticks, 3)
                                  if self.ticks else 0.0),
        }


def _percentile(hist: np.ndarray, q: float, bin_ms: float = _BIN_MS) -> float:
    total = int(hist.sum())
    if total == 0:
        return 0.0
    k = int(np.searchsorted(np.cumsum(hist), np.ceil(q * total)))
    return (k + 1) * bin_ms


class ServingPlane:
    """All service lanes + the report section (see module docstring)."""

    def __init__(self, cfg: ServingConfig, lanes: list[_Lane],
                 tick_s: float):
        self.cfg = cfg
        self.lanes = lanes
        self.tick_s = tick_s
        # chaos seam: optional FaultInjector (overload-burst demand
        # multiplier + tiered brownout shedding); None = no-chaos path
        self.fault_injector = None

    # --------------------------------------------------------- construction
    @classmethod
    def from_sim(cls, sim, cfg: ServingConfig, *, seed: int) -> "ServingPlane":
        """Build lanes from a :class:`ClusterSim`'s fleet layout.  Arrival
        seeds derive from ``seed`` per lane (decoupled from the engine's
        trace/failure stream, like fault campaigns and agents)."""
        tick_s = sim.cfg.tick_s
        horizon_s = sim.cfg.horizon_s
        lanes: list[_Lane] = []
        nominal = {}
        for si, svc in enumerate(SERVICES):
            idx = np.flatnonzero(sim.service_idx == si)
            if idx.size:
                nominal[si] = (ONLINE_SERVICE_PROFILES[svc]["qps_capacity"]
                               * float(sim.speed[idx].sum()))
        nominal_total = sum(nominal.values())
        slo_overrides = dict(cfg.slo_ms)
        for si, svc in enumerate(SERVICES):
            if si not in nominal:
                continue
            idx = np.flatnonzero(sim.service_idx == si)
            prof = ONLINE_SERVICE_PROFILES[svc]
            # target mean rate: the load knob against nominal capacity,
            # or an explicit fleet rate split capacity-proportionally
            rate = (cfg.load * nominal[si] if cfg.rate_rps is None
                    else cfg.rate_rps * nominal[si] / nominal_total)
            process = cls._build_process(cfg, sim, si, idx, rate,
                                         horizon_s, seed)
            lanes.append(_Lane(
                svc, idx, sim.speed[idx].astype(np.float64), process,
                resolve_admission(cfg.admission, slack=cfg.admission_slack),
                slo_ms=slo_overrides.get(
                    svc, cfg.slo_latency_mult * prof["base_latency_ms"]),
                base_latency_ms=prof["base_latency_ms"],
                qps_capacity=prof["qps_capacity"],
                size_rng=_rng([seed, si, 1]),
                sigma=cfg.request_size_sigma,
                sub=cfg.subcohorts))
        return cls(cfg, lanes, tick_s)

    @staticmethod
    def _build_process(cfg: ServingConfig, sim, si: int, idx: np.ndarray,
                       rate: float, horizon_s: float,
                       seed: int) -> ArrivalProcess:
        if cfg.arrivals == "poisson":
            return ArrivalProcess.poisson(rate, seed=[seed, si])
        if cfg.arrivals == "burst":
            return ArrivalProcess.burst(
                rate, mult=cfg.burst_mult, period_s=cfg.burst_period_s,
                burst_len_s=cfg.burst_len_s, seed=[seed, si])
        if cfg.arrivals == "diurnal":
            # the canonical coupling: arrivals follow the exact QPS curve
            # the engines read (sim.tick_qps memoizes the row per tick),
            # rescaled so the mean lands at load × nominal capacity
            mask = sim.service_idx == si
            base_sum = float(sim.qps_bank.base[mask].sum())
            scale = rate / max(base_sum, 1e-9)

            def rate_fn(t, _qps=sim.tick_qps, _mask=mask, _scale=scale):
                return _scale * float(_qps(t)[_mask].sum())

            return ArrivalProcess.diurnal(rate_fn, seed=[seed, si])
        # trace-replay: materialized Philly-style skewed request trace
        expect = rate * horizon_s
        if expect > _MAX_TRACE_REQUESTS:
            raise ValueError(
                f"trace-replay would materialize ~{expect:.0f} request "
                f"timestamps (> {_MAX_TRACE_REQUESTS}); use the 'diurnal' "
                f"kind for fleet-scale serving runs")
        times = philly_request_times(_rng([seed, si, 7]), rate=rate,
                                     horizon_s=horizon_s)
        return ArrivalProcess.trace_replay(times)

    def attach_tracer(self, tracer) -> None:
        """Attach a request tracer (an observability plane's) to every lane: one
        ``request_batch`` row per continuous-batching drain, one
        ``request_shed`` row per admission shed, in deterministic
        lane/tick order."""
        for lane in self.lanes:
            lane.tracer = tracer

    # ------------------------------------------------------------- per-tick
    def on_tick(self, t: float, slowdown: np.ndarray, act: np.ndarray,
                outage: np.ndarray) -> None:
        """Advance every lane one tick.  Called from the engine-agnostic
        accounting epilogue (:meth:`ClusterSim._account`) with per-tick
        arrays that are bitwise-identical across tick engines."""
        dt = self.tick_s
        inj = self.fault_injector
        demand_mult = inj.serving_burst_mult(t) if inj is not None else 1.0
        brownout = inj.brownout_frac(t) if inj is not None else 0.0
        for lane in self.lanes:
            idx = lane.idx
            up = act[idx] & ~outage[idx]
            if up.any():
                slow = slowdown[idx][up]
                capacity = lane.qps_capacity * float(
                    (lane.speed[up] / slow).sum())
                service_ms = lane.base_latency_ms * float(slow.mean())
            else:
                capacity = 0.0
                service_ms = lane.base_latency_ms
            lane.step(t, dt, capacity, service_ms,
                      demand_mult=demand_mult, brownout_frac=brownout)

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        """The schema-versioned ``"serving"`` report section."""
        services = {ln.service: ln.summary() for ln in self.lanes}
        hist = np.zeros(_N_BINS, np.int64)
        for ln in self.lanes:
            hist += ln.hist
        served = sum(s["served"] for s in services.values())
        shed = sum(s["shed"] for s in services.values())
        within = sum(ln.within_slo for ln in self.lanes)
        done = served + shed
        return {
            "schema": SERVING_SCHEMA,
            "arrivals": self.cfg.arrivals,
            "admission": self.cfg.admission,
            "load": round(self.cfg.load, 6),
            "request_size_sigma": round(self.cfg.request_size_sigma, 6),
            "services": services,
            "total": {
                "arrived": sum(s["arrived"] for s in services.values()),
                "served": served,
                "shed": shed,
                "queued_end": sum(s["queued_end"] for s in services.values()),
                "p50_ms": _percentile(hist, 0.50),
                "p99_ms": _percentile(hist, 0.99),
                "slo_attainment": round(within / done, 6) if done else 1.0,
            },
        }
