"""Horizontal autoscaling for online services — the service-manager piece
the paper references ("deploys containers, discovers service, and autoscales
horizontal pods").

Reactive target-tracking: keep per-replica load (QPS / capacity) near a
target band with hysteresis and cooldown.  Interacts with MuxFlow: scaling
*down* frees whole devices to become Healthy share targets at the next
matching round; scaling *up* evicts the offline partner first (the same
SysMonitor-eviction path), so online capacity always wins.

Copied from `repro/core/autoscaler.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class AutoscalerConfig:
    target_load: float = 0.6          # desired per-replica QPS/capacity
    upper: float = 0.8                # scale up above this
    lower: float = 0.35               # scale down below this
    min_replicas: int = 1
    max_replicas: int = 64
    cooldown_s: float = 300.0
    scale_down_stability_s: float = 600.0


@dataclasses.dataclass
class ScaleDecision:
    replicas: int
    delta: int
    reason: str


class Autoscaler:
    def __init__(self, cfg: AutoscalerConfig, replicas: int,
                 qps_capacity_per_replica: float):
        self.cfg = cfg
        self.replicas = replicas
        self.capacity = qps_capacity_per_replica
        self._last_scale_at = -math.inf
        self._below_since: float | None = None

    def observe(self, total_qps: float, now: float) -> ScaleDecision | None:
        cfg = self.cfg
        load = total_qps / max(self.replicas * self.capacity, 1e-9)
        if now - self._last_scale_at < cfg.cooldown_s:
            return None
        if load > cfg.upper:
            want = min(cfg.max_replicas,
                       max(self.replicas + 1,
                           math.ceil(total_qps / (self.capacity * cfg.target_load))))
            if want > self.replicas:
                delta = want - self.replicas
                self.replicas = want
                self._last_scale_at = now
                self._below_since = None
                return ScaleDecision(want, delta, f"load {load:.2f} > {cfg.upper}")
            return None
        if load < cfg.lower:
            if self._below_since is None:
                self._below_since = now
                return None
            if now - self._below_since < cfg.scale_down_stability_s:
                return None
            want = max(cfg.min_replicas,
                       math.ceil(total_qps / (self.capacity * cfg.target_load)))
            if want < self.replicas:
                delta = want - self.replicas
                self.replicas = want
                self._last_scale_at = now
                self._below_since = None
                return ScaleDecision(want, delta,
                                     f"load {load:.2f} < {cfg.lower} (stable)")
            return None
        self._below_since = None
        return None
