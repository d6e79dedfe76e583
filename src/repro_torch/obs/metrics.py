"""Typed metric families and the per-tick fleet rollup recorder.

:class:`MetricsRegistry` holds counter/gauge/histogram families keyed by
``name`` + label names, Prometheus-style; children are keyed by label
values.  :class:`FleetMetricsRecorder` drives it from the engine-agnostic
accounting epilogue (``ClusterSim._account`` → ``obs.on_tick``), folding the
per-tick arrays into per-pool window accumulators and emitting one JSONL
sample row per (metric, labelset) per window — the timeseries the paper's
deployment figures (fig14/15: fleet gpu_util / SM activity / memory climbing
under sharing) are drawn from, here reproduced from the sim's own telemetry.

Determinism: the recorder consumes only per-tick arrays that are
bitwise-identical across the numpy and torch tick engines — including the
post-tick ``has_job``/``mstate`` snapshots the cores export specifically for
this purpose (reading live monitor state would see block-end values in torch
block mode).  Window boundaries count ticks, not wall time.

Copied from `repro/obs/metrics.py`.  On the torch engine ``has_job`` and
``mstate`` come back from the block's byte buffer as bool and int8; every
reduction here gives the numpy core's bytes on them.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.export import LABEL_NAME_RE, METRIC_NAME_RE, JsonlWriter

METRICS_SCHEMA = "repro.obs.metrics/v1"

#: default histogram buckets for slowdown-like ratios (1.0 = no slowdown)
SLOWDOWN_BUCKETS = (1.0, 1.02, 1.05, 1.1, 1.15, 1.2, 1.3, 1.5, 2.0, 3.0)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)


class _Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class _Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class _Histogram:
    __slots__ = ("_buckets", "bucket_counts", "sum", "count")

    def __init__(self, buckets: tuple):
        self._buckets = buckets
        self.bucket_counts = [0] * len(buckets)   # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += float(v)
        self.count += 1
        for i, ub in enumerate(self._buckets):
            if v <= ub:
                self.bucket_counts[i] += 1
                return
        # above the last bound: counted only in the implicit +Inf bucket


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class _Family:
    """One metric: a kind, a help string, label names, and children keyed
    by label values."""

    def __init__(self, kind: str, name: str, help: str,
                 label_names: tuple, buckets: tuple | None = None):
        if not METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not LABEL_NAME_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name!r}")
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.buckets = tuple(float(b) for b in (buckets or ())) or None
        if kind == "histogram" and self.buckets is not None:
            if list(self.buckets) != sorted(self.buckets):
                raise ValueError(f"histogram {name!r} buckets not sorted")
        self._children: dict[tuple, object] = {}

    def labels(self, **kv):
        """The child for one label-value assignment (created on demand)."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[ln]) for ln in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = (_Histogram(self.buckets) if self.kind == "histogram"
                     else _KINDS[self.kind]())
            self._children[key] = child
        return child

    # label-less convenience: the family acts as its own single child
    def _solo(self):
        return self.labels()

    def inc(self, v: float = 1.0) -> None:
        self._solo().inc(v)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    def samples(self):
        """``(labels, child)`` pairs sorted by label values — the canonical
        export order."""
        for key in sorted(self._children):
            yield (tuple(zip(self.label_names, key)), self._children[key])


class MetricsRegistry:
    """A namespace of metric families.  Re-registering a name returns the
    existing family (kind and labels must match — drift is a bug)."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _register(self, kind: str, name: str, help: str, labels: tuple,
                  buckets: tuple | None = None) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} "
                    f"with labels {fam.label_names}")
            return fam
        fam = _Family(kind, name, help, tuple(labels), buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "", labels: tuple = ()):
        return self._register("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()):
        return self._register("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS):
        return self._register("histogram", name, help, labels, buckets)

    def collect(self):
        """Families sorted by name — the canonical export order."""
        for name in sorted(self._families):
            yield self._families[name]

    @property
    def n_series(self) -> int:
        return sum(len(f._children) for f in self._families.values())


class FleetMetricsRecorder:
    """Windowed per-pool fleet rollups from the tick epilogue.

    One JSONL ``sample`` row per (metric, labelset) lands at each window
    boundary (``every_s`` of sim time, counted in ticks); gauges carry
    window means, counters carry run-cumulative totals, histograms carry
    run-cumulative buckets.  A trailing partial window flushes at
    ``finalize``.
    """

    def __init__(self, sim, writer: JsonlWriter, *, every_s: float = 600.0,
                 serving=None):
        from repro_torch.core.sysmonitor import S_HEALTHY
        self._healthy = S_HEALTHY
        self.registry = MetricsRegistry()
        self.writer = writer
        self.serving = serving
        self._sim = sim
        self.pools = list(sim.pool_names)
        self._pool_of = sim.pool_of
        P = len(self.pools)
        self._pool_n = np.bincount(sim.pool_of, minlength=P).astype(
            np.float64)
        self.every_ticks = max(1, int(round(every_s / sim.cfg.tick_s)))
        self.window_s = self.every_ticks * sim.cfg.tick_s
        self._tick_i = 0
        self._win_ticks = 0
        self.windows = 0
        # per-device window accumulators, one row per rollup key; the pool
        # reduction (bincount) runs once per *window*, not per tick — the
        # per-tick cost is a handful of in-place vector adds.  slow_busy
        # and disable ride the same array, so alerting adds no per-tick
        # allocation.
        self._keys = ("act", "busy", "sched", "util", "sm", "mem",
                      "on_sm", "off_share", "qps", "slow_busy", "disable")
        n = int(sim.cfg.n_devices)
        self._n_dev = float(n)
        self._tick_s = float(sim.cfg.tick_s)
        self._dev_acc = np.zeros((len(self._keys), n), np.float64)
        self._tmp = np.empty(n, np.float64)      # per-tick scratch buffer
        self._tmpb = np.empty(n, bool)
        self._tmpb2 = np.empty(n, bool)
        self._prev_healthy = np.zeros(n, bool)   # devices start S_INIT
        self._prev_totals: dict[str, float] = {}
        self.alerts = None                       # optional AlertEngine
        r = self.registry
        pool = ("pool",)
        self.g_devices = r.gauge(
            "fleet_devices", "devices in the pool", pool)
        self.g_active = r.gauge(
            "fleet_active_frac", "window-mean fraction of devices alive "
            "(not failed)", pool)
        self.g_busy = r.gauge(
            "fleet_busy_frac", "window-mean fraction of devices running an "
            "offline co-located job", pool)
        self.g_sched = r.gauge(
            "fleet_schedulable_frac", "window-mean fraction of devices the "
            "SysMonitor reports Healthy (schedulable)", pool)
        self.g_util = r.gauge(
            "fleet_gpu_util", "window-mean DCGM-style gpu_util over active "
            "devices (fig14)", pool)
        self.g_sm = r.gauge(
            "fleet_sm_activity", "window-mean SM activity over active "
            "devices (fig15)", pool)
        self.g_mem = r.gauge(
            "fleet_mem_used_frac", "window-mean memory-used fraction over "
            "active devices (fig15)", pool)
        self.g_on_sm = r.gauge(
            "fleet_online_sm_activity", "window-mean online-share SM "
            "activity over active devices", pool)
        self.g_off_sm = r.gauge(
            "fleet_offline_sm_share", "window-mean achieved offline SM "
            "share over active devices", pool)
        self.g_qps = r.gauge(
            "fleet_qps", "window-mean offered online QPS", pool)
        self.g_busy_slow = r.gauge(
            "fleet_busy_slowdown", "window-mean online slowdown over busy "
            "shared device-ticks (1.0 when none busy)", pool)
        self.g_disables = r.gauge(
            "fleet_device_disables_window", "SysMonitor healthy -> "
            "non-schedulable transitions this window", pool)
        self.c_started = r.counter(
            "jobs_started_total", "offline job placements")
        self.c_finished = r.counter(
            "jobs_finished_total", "offline jobs completed")
        self.c_evicted = r.counter(
            "jobs_evicted_total", "offline jobs evicted (counted evictions)")
        self.c_errors = r.counter(
            "errors_injected_total", "injected offline container errors")
        self.c_incidents = r.counter(
            "online_incidents_total", "errors that propagated to the online "
            "service")
        # per-window deltas alongside the cumulative counters, so burn-rate
        # rules (and dashboards) never difference cumulative series
        self.g_started_w = r.gauge(
            "jobs_started_window", "offline job placements this window")
        self.g_finished_w = r.gauge(
            "jobs_finished_window", "offline jobs completed this window")
        self.g_evicted_w = r.gauge(
            "jobs_evicted_window", "offline jobs evicted this window")
        self.g_errors_w = r.gauge(
            "errors_injected_window", "injected offline container errors "
            "this window")
        self.g_incidents_w = r.gauge(
            "online_incidents_window", "errors propagated to the online "
            "service this window")
        self.h_slow = r.histogram(
            "tick_online_slowdown", "per-tick busy-mean online slowdown",
            buckets=SLOWDOWN_BUCKETS)
        for p, name in enumerate(self.pools):
            self.g_devices.labels(pool=name).set(float(self._pool_n[p]))
        if serving is not None:
            svc = ("service",)
            self.c_req_arrived = r.counter(
                "serving_requests_arrived_total", "requests entering the "
                "lane queue", svc)
            self.c_req_served = r.counter(
                "serving_requests_served_total", "requests drained by "
                "continuous batching", svc)
            self.c_req_shed = r.counter(
                "serving_requests_shed_total", "requests shed by admission",
                svc)
            self.g_req_queue = r.gauge(
                "serving_queue_depth", "requests queued at the window "
                "boundary", svc)
            self.g_att_w = r.gauge(
                "serving_window_attainment", "SLO attainment over this "
                "window's served+shed requests (1.0 when idle)", svc)
            self.g_p99_w = r.gauge(
                "serving_window_p99_ms", "p99 latency over this window's "
                "served requests (4 ms quantized)", svc)
        writer.write({"kind": "header", "schema": METRICS_SCHEMA,
                      "window_s": self.window_s, "tick_s": sim.cfg.tick_s,
                      "pools": self.pools,
                      "n_devices": int(sim.cfg.n_devices)})

    # ------------------------------------------------------------- per-tick
    # Hot path: ~15 vector passes over the fleet per tick.  Masked products
    # go through one reused scratch buffer so no per-tick temporaries are
    # allocated (a flagship campaign is 1440 ticks × 20k devices).
    def on_tick(self, sim, inp: dict, core: dict) -> None:
        d = self._dev_acc
        tmp, tmpb = self._tmp, self._tmpb
        act = core["act"]
        busy = core["busy"]
        d[0] += act
        d[1] += busy
        np.equal(core["mstate"], self._healthy, out=tmpb)
        d[2] += tmpb
        # healthy -> non-schedulable transitions (device-disable spikes)
        np.greater(self._prev_healthy, tmpb, out=self._tmpb2)
        d[10] += self._tmpb2
        np.copyto(self._prev_healthy, tmpb)
        np.multiply(core["tele_util"], act, out=tmp)
        d[3] += tmp
        np.multiply(core["tele_sm"], act, out=tmp)
        d[4] += tmp
        np.multiply(core["tele_mem"], act, out=tmp)
        d[5] += tmp
        np.multiply(inp["on"]["sm_activity"], act, out=tmp)
        d[6] += tmp
        np.logical_and(core["has_job"], act, out=tmpb)
        np.multiply(inp["used_min"], tmpb, out=tmp)
        d[7] += tmp
        d[8] += inp["qps"]
        # busy-weighted slowdown through the scratch buffer (no fancy-index
        # temporary); the same row feeds the online-slowdown alert rule
        np.multiply(core["slowdown"], busy, out=tmp)
        d[9] += tmp
        n_busy = np.count_nonzero(busy)
        if n_busy:
            self.h_slow.observe(float(tmp.sum()) / n_busy)
        self._tick_i += 1
        self._win_ticks += 1
        if self._win_ticks >= self.every_ticks:
            self._emit(inp["t"])

    # --------------------------------------------------------------- window
    def _emit(self, t: float) -> None:
        po = self._pool_of
        P = len(self.pools)
        acc = {k: np.bincount(po, weights=self._dev_acc[i], minlength=P)
               for i, k in enumerate(self._keys)}
        ticks = self._win_ticks
        win_h = ticks * self._tick_s / 3600.0
        # pool/service/fleet signal docs for the alert engine, built from
        # the same accumulators (and only when alerting is on — the metric
        # bytes themselves never depend on whether alerts are enabled)
        pool_sig = {} if self.alerts is not None else None
        for p, name in enumerate(self.pools):
            dev = self._pool_n[p] * ticks
            act = acc["act"][p]
            frac = lambda x: float(x / dev) if dev else 0.0  # noqa: E731
            over_act = lambda x: float(x / act) if act else 0.0  # noqa: E731
            lab = {"pool": name}
            self.g_active.labels(**lab).set(frac(acc["act"][p]))
            self.g_busy.labels(**lab).set(frac(acc["busy"][p]))
            self.g_sched.labels(**lab).set(frac(acc["sched"][p]))
            self.g_util.labels(**lab).set(over_act(acc["util"][p]))
            self.g_sm.labels(**lab).set(over_act(acc["sm"][p]))
            self.g_mem.labels(**lab).set(over_act(acc["mem"][p]))
            self.g_on_sm.labels(**lab).set(over_act(acc["on_sm"][p]))
            self.g_off_sm.labels(**lab).set(over_act(acc["off_share"][p]))
            self.g_qps.labels(**lab).set(float(acc["qps"][p] / ticks))
            busy_t = acc["busy"][p]
            busy_slow = float(acc["slow_busy"][p] / busy_t) if busy_t else 1.0
            self.g_busy_slow.labels(**lab).set(busy_slow)
            disables = float(acc["disable"][p])
            self.g_disables.labels(**lab).set(disables)
            if pool_sig is not None:
                pool_h = self._pool_n[p] * win_h
                pool_sig[name] = {
                    "busy_slowdown": busy_slow,
                    "device_disables": disables,
                    "device_disables_per_1k_hour": (
                        disables / pool_h * 1e3 if pool_h else 0.0),
                    "unschedulable_frac": frac(
                        acc["act"][p] - acc["sched"][p]),
                }
        fleet_delta: dict[str, float] = {}
        for fam, win_gauge, total in self._sim_totals():
            prev = self._prev_totals.get(fam.name, 0.0)
            delta = total - prev
            fam.inc(delta)
            win_gauge.set(delta)
            self._prev_totals[fam.name] = total
            fleet_delta[fam.name] = delta
        svc_sig = {} if self.alerts is not None else None
        if self.serving is not None:
            from repro_torch.obs.alerts import ATTAINMENT_OBJECTIVE
            for lane in self.serving.lanes:
                lab = {"service": lane.service}
                for fam, total in (
                        (self.c_req_arrived, float(lane.arrived)),
                        (self.c_req_served, float(lane.served)),
                        (self.c_req_shed, float(lane.shed))):
                    key = f"{fam.name}:{lane.service}"
                    prev = self._prev_totals.get(key, 0.0)
                    fam.labels(**lab).inc(total - prev)
                    self._prev_totals[key] = total
                self.g_req_queue.labels(**lab).set(
                    float(sum(c[1] for c in lane.queue)))
                win = lane.window_snapshot()
                done = win["served"] + win["shed"]
                attain = win["within_slo"] / done if done else 1.0
                self.g_att_w.labels(**lab).set(attain)
                self.g_p99_w.labels(**lab).set(win["p99_ms"])
                if svc_sig is not None:
                    svc_sig[lane.service] = {
                        "attainment": attain,
                        "burn_rate": ((1.0 - attain)
                                      / (1.0 - ATTAINMENT_OBJECTIVE)),
                        "p99_ms": win["p99_ms"],
                        "p99_slo_ratio": win["p99_ms"] / lane.slo_ms,
                        "arrived": float(win["arrived"]),
                        "shed": float(win["shed"]),
                        "shed_frac": (win["shed"] / win["arrived"]
                                      if win["arrived"] else 0.0),
                    }
        self._write_samples(t)
        if self.alerts is not None:
            fleet_sig = {
                "errors": fleet_delta["errors_injected_total"],
                "errors_per_device_hour": (
                    fleet_delta["errors_injected_total"]
                    / (self._n_dev * win_h) if win_h else 0.0),
                "online_incidents": fleet_delta[
                    "online_incidents_total"],
                "evictions": fleet_delta["jobs_evicted_total"],
            }
            chaos = getattr(self._sim, "chaos", None)
            if chaos is not None:
                fleet_sig.update(chaos.window_signals())
            self.alerts.on_window(t, {
                "t": t, "window_s": ticks * self._tick_s,
                "fleet": fleet_sig,
                "pool": pool_sig,
                "service": svc_sig,
            })
        self.windows += 1
        self._win_ticks = 0
        self._dev_acc[:] = 0.0

    def _sim_totals(self):
        sim = self._sim
        return ((self.c_started, self.g_started_w, float(sim.executions)),
                (self.c_finished, self.g_finished_w,
                 float(len(sim.finished))),
                (self.c_evicted, self.g_evicted_w, float(sim.evictions)),
                (self.c_errors, self.g_errors_w,
                 float(sim.errors_injected)),
                (self.c_incidents, self.g_incidents_w,
                 float(sim.online_incidents)))

    def _write_samples(self, t: float) -> None:
        w = self.writer
        for fam in self.registry.collect():
            for labels, child in fam.samples():
                row = {"kind": "sample", "t": t, "name": fam.name,
                       "labels": dict(labels)}
                if fam.kind == "histogram":
                    row["count"] = child.count
                    row["sum"] = child.sum
                    row["le"] = list(fam.buckets)
                    row["buckets"] = list(child.bucket_counts)
                else:
                    row["value"] = child.value
                w.write(row)

    # ------------------------------------------------------------ lifecycle
    def finalize(self, t_end: float) -> None:
        if self._win_ticks:
            self._emit(t_end)

    def summary(self) -> dict:
        return {"schema": METRICS_SCHEMA, "rows": self.writer.rows,
                "windows": self.windows, "window_s": self.window_s,
                "series": self.registry.n_series,
                "digest": self.writer.digest()}
