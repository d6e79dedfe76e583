"""Seeded chaos campaigns: deterministic control-plane fault injection.

Where :class:`repro_torch.cluster.faults.FaultCampaign` injects *GPU-side*
errors (the paper's xid/ECC/signal mix), :class:`ChaosCampaign` perturbs
the **infrastructure around the simulator** — node agents, the WAL, the
predictor, the matcher, the serving lanes — through the
:class:`~repro_torch.chaos.injector.FaultInjector` seams.  Every fault class is
paired with a typed recovery on the graceful-degradation ladder:

================  ==============================  =======================
fault kind        injected where                  degradation / recovery
================  ==============================  =======================
``agent_crash``   agent misses heartbeats         restart after
                                                  ``agent_restart_s``
``clock_skew``    heartbeat timestamps skewed     skew episode expires
``wal_io``        transient append/flush/fsync    store's bounded retry
                  IO errors                       ladder absorbs them
``predictor_outage``  trained predictor down      static share-table
                                                  weight grid
``matcher_budget``    KM time budget exhausted    greedy-FIFO placement
``serving_burst``     arrival overload burst      tiered brownout shed
================  ==============================  =======================

Determinism contract (same as the fault campaign): the campaign owns a
dedicated RNG stream decoupled from scenario/fleet/serving seeds, draws a
**fixed shape** of randomness per active tick regardless of what fires,
and emits :data:`~repro_torch.cluster.events.EventKind.CHAOS_INJECT` /
``RECOVERY`` event pairs so a report can prove every injected fault was
matched by a recovery.  WAL faults are consumed *inside* ``bus.emit``
(the store sink appends there), so their events are deferred one tick and
drained at the next ``inject()`` — the bus is never re-entered.

Copied from `repro/chaos/campaign.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CHAOS_SCHEMA = "repro.chaos/v1"

#: fault kinds a campaign can inject (report keys; sorted in summaries)
CHAOS_KINDS = ("agent_crash", "clock_skew", "matcher_budget",
               "predictor_outage", "serving_burst", "wal_io")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Declarative chaos-campaign parameters (all rates are expected
    events per hour; ``0.0`` disables that fault class).

    Keep ``end_s`` at least a few episode lengths before the scenario
    horizon so every open episode can close and pair with its recovery
    event — the verification harness clamps and asserts this.
    """

    #: per-device agent crash rate; a crashed agent misses heartbeats
    agent_crash_rate_per_hour: float = 0.0
    #: how long a crashed agent stays down before its supervisor restarts it
    agent_restart_s: float = 240.0
    #: per-device clock-skew episode rate
    clock_skew_rate_per_hour: float = 0.0
    #: skew magnitude (heartbeats stamped this far in the past)
    clock_skew_s: float = 120.0
    #: skew episode length
    clock_skew_len_s: float = 600.0
    #: run-level transient WAL IO fault-burst rate
    wal_fault_rate_per_hour: float = 0.0
    #: consecutive IO attempts failed per burst — keep it at most the
    #: store's ``max_io_retries`` so the ladder always absorbs the burst
    wal_fault_burst: int = 2
    #: run-level predictor outage rate
    predictor_outage_rate_per_hour: float = 0.0
    #: predictor outage length
    predictor_outage_s: float = 900.0
    #: run-level matcher time-budget exhaustion rate (one round each)
    matcher_budget_rate_per_hour: float = 0.0
    #: run-level serving overload-burst rate
    serving_burst_rate_per_hour: float = 0.0
    #: overload burst length
    serving_burst_s: float = 600.0
    #: arrival demand multiplier while a burst is open
    serving_burst_mult: float = 2.5
    #: brownout shed fraction per tier (tiers escalate 1→3 over the burst)
    brownout_shed_frac: float = 0.10
    #: campaign window (defaults JSON-safe, like FaultCampaignConfig)
    start_s: float = 0.0
    end_s: float = 1e18

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


class ChaosCampaign:
    """Drives one seeded chaos campaign against a ControlPlane's stack.

    Implements the full :class:`~repro_torch.chaos.injector.FaultInjector`
    protocol; the control plane hands ``self`` to every seam
    (agents/store/sim/serving) and calls :meth:`inject` once per tick,
    right after the GPU fault campaign and before agents observe.
    """

    def __init__(self, cfg: ChaosConfig, sim, seed: int, bus=None):
        self.cfg = cfg
        self.sim = sim
        self.bus = bus
        #: serving plane (set by the control plane) for brownout accounting
        self.serving = None
        self._n = sim.cfg.n_devices
        self.rng = np.random.default_rng(seed)
        # episode state: *_until timestamps (0 = closed; the sim clock
        # starts at tick_s > 0 so 0 is never an open episode)
        self.agent_down_until = np.zeros(self._n)
        self.skew_until = np.zeros(self._n)
        self.predictor_down_until = 0.0
        self.serving_burst_until = 0.0
        self._burst_started = 0.0
        self._matcher_armed = False
        # WAL fault plumbing (consumed inside bus.emit → drained next tick)
        self._wal_pending = 0
        self._wal_consumed = 0
        self._wal_retries = 0
        self._wal_reported_faults = 0
        self._wal_reported_retries = 0
        # ladder counters / recovery-event marks
        self._pred_fallback_rounds = 0
        self._pred_mark = 0
        self._matcher_fallbacks = 0
        self._brownout_mark = 0
        self.injected_by_kind: dict[str, int] = {}
        self.recovered_by_kind: dict[str, int] = {}
        self._sig_prev: dict[str, float] = {}

    # ------------------------------------------------------------ injection
    def inject(self, t: float, tick_s: float) -> None:
        """Advance the campaign one tick: close expired episodes (emitting
        their recovery events), drain deferred WAL fault events, then draw
        this tick's fixed-shape randomness and maybe open new episodes."""
        cfg = self.cfg
        self._expire(t)
        self._drain_wal(t)
        if not cfg.active(t):
            # outside the window nothing new arms, and any un-consumed WAL
            # burst is disarmed so the post-run flush can't fire it
            self._wal_pending = 0
            self._matcher_armed = False
            return
        # fixed-shape draws every active tick, independent of what fires
        dev_u = self.rng.random((2, self._n))
        fleet_u = self.rng.random(4)
        p = tick_s / 3600.0
        if cfg.agent_crash_rate_per_hour > 0:
            up = self.agent_down_until <= 0
            crash = up & (dev_u[0] < cfg.agent_crash_rate_per_hour * p)
            for i in np.flatnonzero(crash):
                self.agent_down_until[i] = t + cfg.agent_restart_s
                self._fire(t, "agent_crash", device=int(i),
                           data=(("restart_s", cfg.agent_restart_s),))
        if cfg.clock_skew_rate_per_hour > 0 and cfg.clock_skew_s > 0:
            calm = self.skew_until <= 0
            skew = calm & (dev_u[1] < cfg.clock_skew_rate_per_hour * p)
            for i in np.flatnonzero(skew):
                self.skew_until[i] = t + cfg.clock_skew_len_s
                self._fire(t, "clock_skew", device=int(i),
                           data=(("skew_s", cfg.clock_skew_s),))
        if (cfg.wal_fault_rate_per_hour > 0 and self._wal_pending == 0
                and fleet_u[0] < cfg.wal_fault_rate_per_hour * p):
            self._wal_pending = int(cfg.wal_fault_burst)
        if (cfg.predictor_outage_rate_per_hour > 0
                and self.predictor_down_until <= 0
                and fleet_u[1] < cfg.predictor_outage_rate_per_hour * p):
            self.predictor_down_until = t + cfg.predictor_outage_s
            self._pred_mark = self._pred_fallback_rounds
            self._fire(t, "predictor_outage",
                       data=(("outage_s", cfg.predictor_outage_s),))
        if (cfg.matcher_budget_rate_per_hour > 0 and not self._matcher_armed
                and fleet_u[2] < cfg.matcher_budget_rate_per_hour * p):
            self._matcher_armed = True
        if (cfg.serving_burst_rate_per_hour > 0
                and self.serving_burst_until <= 0
                and fleet_u[3] < cfg.serving_burst_rate_per_hour * p):
            self.serving_burst_until = t + cfg.serving_burst_s
            self._burst_started = t
            self._brownout_mark = self.brownout_total()
            self._fire(t, "serving_burst",
                       data=(("mult", cfg.serving_burst_mult),
                             ("burst_s", cfg.serving_burst_s)))

    def _expire(self, t: float) -> None:
        back = (self.agent_down_until > 0) & (self.agent_down_until <= t)
        for i in np.flatnonzero(back):
            self._recover(t, "agent_crash", device=int(i),
                          action="agent_restart")
        self.agent_down_until[back] = 0.0
        calm = (self.skew_until > 0) & (self.skew_until <= t)
        for i in np.flatnonzero(calm):
            self._recover(t, "clock_skew", device=int(i),
                          action="skew_cleared")
        self.skew_until[calm] = 0.0
        if 0 < self.predictor_down_until <= t:
            self._recover(
                t, "predictor_outage", action="static_share_table",
                data=(("fallback_rounds",
                       self._pred_fallback_rounds - self._pred_mark),))
            self.predictor_down_until = 0.0
        if 0 < self.serving_burst_until <= t:
            self._recover(
                t, "serving_burst", action="brownout_shed",
                data=(("shed", self.brownout_total() - self._brownout_mark),))
            self.serving_burst_until = 0.0

    def _drain_wal(self, t: float) -> None:
        """Emit the CHAOS_INJECT/RECOVERY pair for WAL faults consumed
        since the last tick.  Deferred because the store consumes faults
        inside ``bus.emit`` (the sink appends there) and the bus must not
        be re-entered; marks are advanced *before* emitting so faults the
        emission itself consumes are picked up next tick."""
        faults = self._wal_consumed - self._wal_reported_faults
        if faults <= 0:
            return
        retries = self._wal_retries - self._wal_reported_retries
        self._wal_reported_faults += faults
        self._wal_reported_retries += retries
        self._fire(t, "wal_io", data=(("faults", faults),))
        self._recover(t, "wal_io", action="bounded_retry",
                      data=(("retries", retries),))

    # ------------------------------------------------------------- events
    # EventKind is imported lazily: repro_torch.chaos must stay importable on its
    # own (scenario/control both import from it), and repro_torch.cluster.events
    # pulls in the whole cluster package, which imports back into chaos.
    def _fire(self, t, fault, device=-1, data=()):
        self.injected_by_kind[fault] = self.injected_by_kind.get(fault, 0) + 1
        if self.bus is not None:
            from repro_torch.cluster.events import EventKind
            self.bus.emit(t, EventKind.CHAOS_INJECT, device=device,
                          data=(("fault", fault),) + tuple(data))

    def _recover(self, t, fault, action, device=-1, data=()):
        self.recovered_by_kind[fault] = (
            self.recovered_by_kind.get(fault, 0) + 1)
        if self.bus is not None:
            from repro_torch.cluster.events import EventKind
            self.bus.emit(t, EventKind.RECOVERY, device=device,
                          data=(("fault", fault), ("action", action))
                          + tuple(data))

    # -------------------------------------------- FaultInjector protocol
    def agent_outage(self, t):
        if self.cfg.agent_crash_rate_per_hour <= 0:
            return None
        return self.agent_down_until > t

    def heartbeat_skew(self, t):
        if self.cfg.clock_skew_rate_per_hour <= 0:
            return None
        return np.where(self.skew_until > t, self.cfg.clock_skew_s, 0.0)

    def store_fault(self, op):
        if self._wal_pending <= 0:
            return False
        self._wal_pending -= 1
        self._wal_consumed += 1
        return True

    def note_io_recovered(self, op, attempts):
        self._wal_retries += int(attempts)

    def predictor_down(self, t):
        return t < self.predictor_down_until

    def note_predictor_fallback(self, t):
        self._pred_fallback_rounds += 1

    def matcher_exhausted(self, t):
        return self._matcher_armed

    def note_matcher_fallback(self, t, n_free, n_jobs):
        # one-shot: the armed budget exhaustion is consumed by this round.
        # _schedule runs in plain Python on both tick engines and outside
        # bus.emit, so emitting the pair immediately here is safe.
        self._matcher_armed = False
        self._matcher_fallbacks += 1
        self._fire(t, "matcher_budget",
                   data=(("free", int(n_free)), ("jobs", int(n_jobs))))
        self._recover(t, "matcher_budget", action="greedy_fifo")

    def serving_burst_mult(self, t):
        if t < self.serving_burst_until:
            return self.cfg.serving_burst_mult
        return 1.0

    def brownout_frac(self, t):
        """Tiered brownout: the shed fraction escalates 1×→3× the base
        fraction over thirds of the burst window."""
        if not t < self.serving_burst_until:
            return 0.0
        frac = (t - self._burst_started) / max(self.cfg.serving_burst_s, 1.0)
        tier = 1 + min(2, int(3.0 * frac))
        return tier * self.cfg.brownout_shed_frac

    # ------------------------------------------------------------ reporting
    def brownout_total(self) -> int:
        if self.serving is None:
            return 0
        return int(sum(lane.brownout_shed for lane in self.serving.lanes))

    def open_faults(self) -> int:
        """Episodes currently open (every one must close before the run
        ends for the fault↔recovery pairing invariant to hold)."""
        n = int((self.agent_down_until > 0).sum())
        n += int((self.skew_until > 0).sum())
        n += 1 if self.predictor_down_until > 0 else 0
        n += 1 if self.serving_burst_until > 0 else 0
        n += 1 if self._wal_consumed > self._wal_reported_faults else 0
        return n

    def summary(self) -> dict:
        """The report's ``"resilience"`` section (JSON-safe, sorted)."""
        inj = dict(sorted(self.injected_by_kind.items()))
        rec = dict(sorted(self.recovered_by_kind.items()))
        unmatched = {k: v - rec.get(k, 0) for k, v in inj.items()
                     if v - rec.get(k, 0)}
        return {
            "schema": CHAOS_SCHEMA,
            "injected": sum(inj.values()),
            "recovered": sum(rec.values()),
            "unmatched": sum(unmatched.values()),
            "unmatched_by_kind": unmatched,
            "open_end": self.open_faults(),
            "injected_by_kind": inj,
            "recovered_by_kind": rec,
            "ladder": {
                "store_faults": self._wal_consumed,
                "store_retries": self._wal_retries,
                "predictor_fallback_rounds": self._pred_fallback_rounds,
                "matcher_fallback_rounds": self._matcher_fallbacks,
                "brownout_shed": self.brownout_total(),
                "agent_restarts": rec.get("agent_crash", 0),
            },
        }

    def window_signals(self) -> dict:
        """Per-window alerting signals (deltas since the last window plus
        the open-fault gauge) merged into the fleet signal dict."""
        cur = {
            "chaos_faults": float(sum(self.injected_by_kind.values())),
            "chaos_recoveries": float(sum(self.recovered_by_kind.values())),
            "chaos_store_retries": float(self._wal_retries),
            "chaos_brownout_shed": float(self.brownout_total()),
        }
        out = {k: v - self._sig_prev.get(k, 0.0) for k, v in cur.items()}
        out["chaos_open_faults"] = float(self.open_faults())
        self._sig_prev = cur
        return out

    # ------------------------------------------------------- snapshotting
    def capture(self) -> dict:
        """Mutable campaign state for tick-boundary snapshots."""
        return {
            "rng": self.rng.bit_generator.state,
            "agent_down_until": np.copy(self.agent_down_until),
            "skew_until": np.copy(self.skew_until),
            "predictor_down_until": self.predictor_down_until,
            "serving_burst_until": self.serving_burst_until,
            "burst_started": self._burst_started,
            "matcher_armed": self._matcher_armed,
            "wal_pending": self._wal_pending,
            "wal_consumed": self._wal_consumed,
            "wal_retries": self._wal_retries,
            "wal_reported_faults": self._wal_reported_faults,
            "wal_reported_retries": self._wal_reported_retries,
            "pred_fallback_rounds": self._pred_fallback_rounds,
            "pred_mark": self._pred_mark,
            "matcher_fallbacks": self._matcher_fallbacks,
            "brownout_mark": self._brownout_mark,
            "injected": dict(self.injected_by_kind),
            "recovered": dict(self.recovered_by_kind),
            "sig_prev": dict(self._sig_prev),
        }

    def restore(self, row: dict) -> None:
        self.rng.bit_generator.state = row["rng"]
        self.agent_down_until = np.copy(row["agent_down_until"])
        self.skew_until = np.copy(row["skew_until"])
        self.predictor_down_until = row["predictor_down_until"]
        self.serving_burst_until = row["serving_burst_until"]
        self._burst_started = row["burst_started"]
        self._matcher_armed = row["matcher_armed"]
        self._wal_pending = row["wal_pending"]
        self._wal_consumed = row["wal_consumed"]
        self._wal_retries = row["wal_retries"]
        self._wal_reported_faults = row["wal_reported_faults"]
        self._wal_reported_retries = row["wal_reported_retries"]
        self._pred_fallback_rounds = row["pred_fallback_rounds"]
        self._pred_mark = row["pred_mark"]
        self._matcher_fallbacks = row["matcher_fallbacks"]
        self._brownout_mark = row["brownout_mark"]
        self.injected_by_kind = dict(row["injected"])
        self.recovered_by_kind = dict(row["recovered"])
        self._sig_prev = dict(row["sig_prev"])
