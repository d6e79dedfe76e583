"""Per-device node agents (§5's DeviceProbe + SysMonitor daemons).

In production every device runs two agents: DeviceProbe samples GPU metrics
and SysMonitor drives the protection state machine; the global scheduler only
trusts devices whose agents are reporting.  :class:`NodeAgentFleet` models
that layer in struct-of-arrays form: each agent heartbeats every
``heartbeat_s`` (dropping a report with probability ``drop_rate`` — flaky
daemons, kubelet restarts, network partitions), and a device whose last
report is older than ``stale_after`` heartbeats is *stale*: the control plane
masks it out of scheduling until the agent reports again.

The agent snapshot wraps the three telemetry sources a real NodeAgent ships:
the VectorSysMonitor state code, the device's current dynamic-SM share, and
the kernel-throttle duty proxy (the SM share actually exercised by the
offline partner).  Snapshot values are *as of each device's last successful
heartbeat* — staleness is visible in the data, exactly the failure mode the
paper's global manager has to tolerate.

Copied from `repro/cluster/agents.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cluster.events import EventBus, EventKind
from repro_torch.core.dynamic_sm import dynamic_sm_array


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    heartbeat_s: float = 30.0
    stale_after: float = 3.0      # heartbeats missed before a device is stale
    drop_rate: float = 0.0        # P(miss a heartbeat report)


def stale_mask(now, last_heartbeat, timeout_s):
    """THE failure-detection predicate: a node is stale/dead when its last
    heartbeat is strictly older than ``timeout_s``.

    Shared by :class:`NodeAgentFleet` (vectorized staleness masking) and
    :class:`repro.runtime.fault_tolerance.HeartbeatMonitor` (per-node
    training-launch supervision) so the two detectors can never drift.
    Works element-wise on arrays and on scalars."""
    return (np.asarray(now) - np.asarray(last_heartbeat)) > timeout_s


class NodeAgentFleet:
    """Vectorized per-device agent state: heartbeats, staleness, and the
    last-reported telemetry snapshot."""

    def __init__(self, n: int, cfg: AgentConfig, seed: int,
                 bus: EventBus | None = None):
        self.n = n
        self.cfg = cfg
        self.bus = bus
        # chaos seam: optional FaultInjector (crashed agents miss their
        # heartbeat; clock skew backdates reported timestamps).  Consults
        # never touch self.rng, so the no-chaos stream is unperturbed.
        self.fault_injector = None
        self.rng = np.random.default_rng(seed)
        self.last_report = np.zeros(n, np.float64)    # all report at t=0
        self.stale = np.zeros(n, bool)
        self.stale_episodes = 0
        self.stale_device_ticks = 0
        self.reports_sent = 0
        self.reports_dropped = 0
        self._next_beat = 0.0
        # last-reported telemetry (NaN until first report lands)
        self.seen = {k: np.full(n, np.nan, np.float64)
                     for k in ("gpu_util", "sm_activity", "mem_used",
                               "sm_clock", "sm_share", "duty")}
        self.seen_state = np.full(n, -1, np.int8)     # SysMonitor state code

    def observe(self, sim, t: float, telemetry: dict) -> np.ndarray:
        """One control-plane tick: heartbeat if due, refresh staleness, and
        return the fresh-agent mask (True = agent reporting, schedulable)."""
        cfg = self.cfg
        inj = self.fault_injector
        if t >= self._next_beat:
            if cfg.drop_rate > 0.0:
                ok = self.rng.random(self.n) >= cfg.drop_rate
            else:
                ok = np.ones(self.n, bool)
            if inj is not None:
                down = inj.agent_outage(t)
                if down is not None:
                    ok = ok & ~down       # crashed agents miss the beat
            self.reports_sent += int(ok.sum())
            self.reports_dropped += int((~ok).sum())
            self.last_report[ok] = t
            if inj is not None:
                skew = inj.heartbeat_skew(t)
                if skew is not None:
                    # skewed clocks stamp reports in the past; enough skew
                    # makes a live device look stale until the episode ends
                    self.last_report[ok] = t - np.broadcast_to(
                        np.asarray(skew, np.float64), (self.n,))[ok]
            # a successful report carries the device's current telemetry
            share = sim.state.sm_share
            duty = np.where(sim.state.has_job, share, 0.0)
            for key, src in (("gpu_util", telemetry.get("gpu_util")),
                             ("sm_activity", telemetry.get("sm_activity")),
                             ("mem_used", telemetry.get("mem_used")),
                             ("sm_clock", telemetry.get("sm_clock")),
                             ("sm_share", share), ("duty", duty)):
                if src is not None:
                    np.copyto(self.seen[key], src, where=ok)
            np.copyto(self.seen_state, sim.monitor.state, where=ok)
            self._next_beat = t + cfg.heartbeat_s
        now_stale = stale_mask(t, self.last_report,
                               cfg.stale_after * cfg.heartbeat_s)
        went_stale = now_stale & ~self.stale
        recovered = ~now_stale & self.stale
        if self.bus is not None:
            for i in np.flatnonzero(went_stale):
                self.bus.emit(t, EventKind.AGENT_STALE, device=int(i))
            for i in np.flatnonzero(recovered):
                self.bus.emit(t, EventKind.AGENT_FRESH, device=int(i))
        self.stale_episodes += int(went_stale.sum())
        self.stale_device_ticks += int(now_stale.sum())
        self.stale = now_stale
        return ~now_stale

    def snapshot(self, now: float) -> dict:
        """Last-reported per-device telemetry (arrays; NaN = never reported)."""
        out = {k: v.copy() for k, v in self.seen.items()}
        out["monitor_state"] = self.seen_state.copy()
        out["stale"] = self.stale.copy()
        out["age_s"] = now - self.last_report
        # §4.3 recommendation from last-reported device SM activity (an
        # upper bound on the online share): what the dynamic-SM allocator
        # would grant an offline partner if it trusted this agent's
        # telemetry; never-reported devices conservatively get the floor
        act = np.nan_to_num(out["sm_activity"], nan=1.0)
        out["dyn_sm_recommended"] = dynamic_sm_array(act)
        return out

    def summary(self) -> dict:
        return {
            "heartbeat_s": self.cfg.heartbeat_s,
            "drop_rate": self.cfg.drop_rate,
            "reports_sent": self.reports_sent,
            "reports_dropped": self.reports_dropped,
            "stale_episodes": self.stale_episodes,
            "stale_device_ticks": self.stale_device_ticks,
            "stale_now": int(self.stale.sum()),
        }
