"""Fault campaigns: seeded §4.2 ErrorKind injection at cluster scale.

A campaign drives extra offline-container errors into the fleet at
configurable per-pool rates, sampling kinds from the production mix
(:data:`repro_torch.core.errors.ERROR_MIX` — Fig. 7 — unless overridden) and
routing every one through the engine's :class:`MixedErrorHandler` via
``ClusterSim.force_error``.  It measures what the paper's Table/Fig. 7
analysis measures: how many injected errors *propagate* to the co-located
online workload with graceful exit enabled vs disabled.

The campaign owns its own RNG stream (derived from the scenario seed), so it
never perturbs the engine's trace/failure stream: the same scenario with the
campaign on and off sees identical diurnal load and hardware failures.

Copied from `repro/cluster/faults.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.errors import ERROR_MIX, ErrorKind, error_from_uniform


@dataclasses.dataclass(frozen=True)
class FaultCampaignConfig:
    rate_per_device_hour: float = 0.0        # baseline rate for every pool
    pool_rates: tuple = ()                   # ((pool_name, rate), ...) overrides
    kind_weights: tuple = ()                 # ((kind_value, weight), ...); empty -> ERROR_MIX
    start_s: float = 0.0
    end_s: float = 1e18          # effectively "until the horizon" (JSON-safe)

    def rate_for(self, pool: str) -> float:
        for name, rate in self.pool_rates:
            if name == pool:
                return rate
        return self.rate_per_device_hour

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


class FaultCampaign:
    """Tick-driven injector with per-kind injection/propagation accounting."""

    def __init__(self, cfg: FaultCampaignConfig, sim, seed: int):
        self.cfg = cfg
        self.sim = sim
        self.rng = np.random.default_rng(seed)
        n = sim.cfg.n_devices
        # per-device injection probability per tick-second
        rates = np.array([cfg.rate_for(name) for name in sim.pool_names])
        self.p_per_s = rates[sim.pool_of] / 3600.0
        self.any_rate = bool((rates > 0).any())
        if cfg.kind_weights:
            self.kinds = [ErrorKind(k) for k, _ in cfg.kind_weights]
            w = np.array([w for _, w in cfg.kind_weights], np.float64)
        else:
            self.kinds = list(ERROR_MIX)
            w = np.array([ERROR_MIX[k] for k in self.kinds], np.float64)
        self.cum = np.cumsum(w / w.sum())
        self.cum[-1] = 1.0   # cumsum can land 1-2 ulp short of 1.0; a draw
        #                      in that sliver would index past the last kind
        self.injected_by_kind: dict[str, int] = {}
        self.propagated_by_kind: dict[str, int] = {}
        self._n = n

    def _sample_kind(self, u: float) -> ErrorKind:
        if self.cfg.kind_weights:
            return self.kinds[int(np.searchsorted(self.cum, u, side="left"))]
        return error_from_uniform(u)

    def inject(self, t: float, dt: float) -> int:
        """Called once per tick *before* the engine tick; returns the number
        of errors injected.  Draws are fixed-shape per tick so the stream is
        reproducible regardless of fleet state."""
        if not self.any_rate or not self.cfg.active(t):
            return 0
        hit_u, kind_u = self.rng.random((2, self._n))
        hit = self.sim.state.has_job & (hit_u < self.p_per_s * dt)
        count = 0
        for i in np.flatnonzero(hit):
            kind = self._sample_kind(float(kind_u[i]))
            handled = self.sim.force_error(int(i), t, kind)
            if handled is None:
                continue
            count += 1
            k = kind.value
            self.injected_by_kind[k] = self.injected_by_kind.get(k, 0) + 1
            if handled.propagated:
                self.propagated_by_kind[k] = (
                    self.propagated_by_kind.get(k, 0) + 1)
        return count

    @property
    def injected(self) -> int:
        return sum(self.injected_by_kind.values())

    @property
    def propagated(self) -> int:
        return sum(self.propagated_by_kind.values())

    def propagation_rate(self) -> float:
        return self.propagated / self.injected if self.injected else 0.0

    def summary(self) -> dict:
        return {
            "injected": self.injected,
            "propagated": self.propagated,
            "propagation_rate": self.propagation_rate(),
            "injected_by_kind": dict(sorted(self.injected_by_kind.items())),
            "propagated_by_kind": dict(sorted(
                self.propagated_by_kind.items())),
        }
