"""Heartbeats, failure detection and elastic membership for the offline
training job, copied from `repro/runtime/fault_tolerance.py` (`NodeState`,
`HeartbeatMonitor`, `ElasticPlan`, `ElasticCoordinator`).

A node missing `timeout_s` of heartbeats is dead; a node whose step time
exceeds `straggler_factor` x the median for `straggler_patience` consecutive
checks is a straggler (SysMonitor's Unhealthy: its offline job is evicted off
the critical path).  `ElasticCoordinator` turns a membership change into an
`ElasticPlan` (`node_failure` or `node_join`, the surviving world and the
checkpoint step to resume from); rebuilding a device mesh from that world is
the caller's, and the port runs on one card, where the plan's world is the
set of hosts to restart on.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


def stale_mask(now, last_heartbeat, timeout_s):
    """The failure-detection predicate, the port's copy of
    `repro/cluster/agents.py`'s: a node is stale/dead when its last
    heartbeat is strictly older than `timeout_s`.  Element-wise on arrays
    and on scalars."""
    return (np.asarray(now) - np.asarray(last_heartbeat)) > timeout_s


@dataclasses.dataclass
class NodeState:
    node_id: int
    last_heartbeat: float
    healthy: bool = True
    slow_ticks: int = 0            # consecutive straggler observations
    step_time_ema: float | None = None


class HeartbeatMonitor:
    """Failure detector: a node missing `timeout_s` of heartbeats is dead;
    a node whose step time exceeds `straggler_factor` × cluster median for
    `straggler_patience` consecutive reports is a straggler."""

    def __init__(self, n_nodes: int, *, timeout_s: float = 30.0,
                 straggler_factor: float = 1.5, straggler_patience: int = 3,
                 now: float | None = None):
        t = time.monotonic() if now is None else now
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.nodes = {i: NodeState(i, t) for i in range(n_nodes)}

    def heartbeat(self, node_id: int, *, step_time: float | None = None,
                  now: float | None = None) -> None:
        t = time.monotonic() if now is None else now
        n = self.nodes.setdefault(node_id, NodeState(node_id, t))
        n.last_heartbeat = t
        if step_time is not None:
            n.step_time_ema = (step_time if n.step_time_ema is None
                               else 0.7 * n.step_time_ema + 0.3 * step_time)

    def check(self, now: float | None = None) -> dict:
        """Returns {"dead": [...], "stragglers": [...], "alive": [...]}."""
        t = time.monotonic() if now is None else now
        dead, alive = [], []
        for n in self.nodes.values():
            (dead if stale_mask(t, n.last_heartbeat, self.timeout_s)
             else alive).append(n)
        times = sorted(n.step_time_ema for n in alive if n.step_time_ema)
        median = times[len(times) // 2] if times else None
        stragglers = []
        for n in alive:
            if (median and n.step_time_ema
                    and n.step_time_ema > self.straggler_factor * median):
                n.slow_ticks += 1
                if n.slow_ticks >= self.straggler_patience:
                    stragglers.append(n.node_id)
            else:
                n.slow_ticks = 0
        return {"dead": [n.node_id for n in dead],
                "stragglers": stragglers,
                "alive": [n.node_id for n in alive]}

    def remove(self, node_id: int) -> None:
        self.nodes.pop(node_id, None)

    def join(self, node_id: int, now: float | None = None) -> None:
        t = time.monotonic() if now is None else now
        self.nodes[node_id] = NodeState(node_id, t)


@dataclasses.dataclass
class ElasticPlan:
    """Outcome of a membership change: which world to rebuild and from which
    checkpoint step to resume."""
    world: list
    resume_step: int
    reason: str


class ElasticCoordinator:
    """Couples the failure detector with checkpoint/restart: on membership
    change, emit a plan (new world, resume step).  The caller restarts on
    the surviving hosts and restores the checkpoint, whose restore does not
    depend on how the job was laid out (checkpoint/checkpointing.py)."""

    def __init__(self, monitor: HeartbeatMonitor, get_ckpt_step):
        self.monitor = monitor
        self.get_ckpt_step = get_ckpt_step
        self._last_world: tuple | None = None

    def poll(self, now: float | None = None) -> ElasticPlan | None:
        status = self.monitor.check(now=now)
        world = tuple(sorted(status["alive"]))
        if self._last_world is None:
            self._last_world = world
            return None
        if world != self._last_world:
            reason = ("node_failure" if len(world) < len(self._last_world)
                      else "node_join")
            self._last_world = world
            return ElasticPlan(world=list(world),
                               resume_step=self.get_ckpt_step(),
                               reason=reason)
        return None
