"""Heterogeneous fleets: named GPU pools with per-pool type, speed, and HBM.

A :class:`FleetSpec` expands a list of :class:`GPUPool` fractions into the
per-device arrays the vectorized engine consumes (``gpu_type``, ``speed``,
``hbm_gb``, ``pool_of``).  Pools are contiguous device ranges sized by the
largest-remainder method, so the same spec always expands to the same fleet.

Copied from `repro/cluster/fleet.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GPUPool:
    """One homogeneous slice of the fleet."""
    name: str
    gpu_type: str              # predictor model key (e.g. "T4", "A10")
    weight: float              # fraction of the fleet (normalized over pools)
    speed: float = 1.0         # offline-throughput multiplier vs T4
    hbm_gb: float = 16.0       # device memory (T4-class default)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_POOLS = (GPUPool("t4", "T4", weight=0.75, speed=1.0, hbm_gb=16.0),
                 GPUPool("a10", "A10", weight=0.25, speed=1.35, hbm_gb=24.0))


class FleetSpec:
    """Per-device arrays for a pooled fleet (the simulator's ``fleet=`` duck
    type: ``gpu_type``, ``speed``, ``hbm_gb``, ``pool_of``, ``pool_names``)."""

    def __init__(self, n_devices: int,
                 pools: tuple[GPUPool, ...] = DEFAULT_POOLS):
        if not pools:
            raise ValueError("FleetSpec needs at least one pool")
        self.pools = tuple(pools)
        self.n = n_devices
        total_w = sum(p.weight for p in pools)
        if total_w <= 0:
            raise ValueError("pool weights must sum to > 0")
        # largest-remainder apportionment -> deterministic pool sizes
        quotas = [p.weight / total_w * n_devices for p in pools]
        counts = [int(q) for q in quotas]
        rem = n_devices - sum(counts)
        order = sorted(range(len(pools)),
                       key=lambda i: (quotas[i] - counts[i], -i), reverse=True)
        for i in order[:rem]:
            counts[i] += 1
        self.counts = counts
        self.pool_names = [p.name for p in pools]
        self.pool_of = np.repeat(np.arange(len(pools), dtype=np.int64),
                                 counts)
        self.gpu_type = [pools[p].gpu_type for p in self.pool_of]
        self.speed = np.array([pools[p].speed for p in self.pool_of],
                              np.float64)
        self.hbm_gb = np.array([pools[p].hbm_gb for p in self.pool_of],
                               np.float64)

    @property
    def gpu_types(self) -> tuple[str, ...]:
        """Distinct predictor model keys, in pool order."""
        seen: list[str] = []
        for p in self.pools:
            if p.gpu_type not in seen:
                seen.append(p.gpu_type)
        return tuple(seen)

    def to_dict(self) -> dict:
        return {"n_devices": self.n,
                "pools": [p.to_dict() for p in self.pools],
                "counts": list(self.counts)}
