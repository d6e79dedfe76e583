"""The paper's policies as registered :class:`SharingPolicy` implementations,
copied from `repro/policies/builtin.py` operation for operation, so both
packages' simulators give equal results under one predictor.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dynamic_sm import dynamic_sm_array, fixed_sm
from repro_torch.core.interference import shared_performance_arrays
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.policies.base import SharingPolicy, register


class DedicatedPolicy(SharingPolicy):
    """Dedicated GPUs (the paper's Online-only baseline): no sharing at all.

    Offline jobs are never scheduled; every device runs its online workload
    alone at exactly base performance.
    """

    name = "online-only"
    description = ("Dedicated GPUs: offline jobs never run, online serves "
                   "at base performance (the paper's pre-MuxFlow state).")
    wants_scheduling = False

    def sm_shares(self, on, idx):
        return np.zeros(idx.shape, np.float64)

    def shared_performance(self, on, off, shares):
        n = on["gpu_util"].shape[0]
        return np.ones(n), np.zeros(n)


class MuxFlowPolicy(SharingPolicy):
    """MuxFlow space-sharing (§4–§5), parameterized into its ablations.

    The full policy uses dynamic SM allocation (§4.3) and matching-based
    scheduling (§5); turning either off yields the paper's MuxFlow-S
    (fixed 40 % SM share), MuxFlow-M (greedy FIFO instead of KM matching),
    and MuxFlow-S-M variants.  Shared performance is the calibrated
    space-sharing interference model (Fig. 4).
    """

    needs_predictor = True

    def __init__(self, name: str = "muxflow", *, use_dynamic_sm: bool = True,
                 use_matching: bool = True):
        self.name = name
        self.use_dynamic_sm = use_dynamic_sm
        self.use_matching = use_matching
        parts = []
        if not use_dynamic_sm:
            parts.append("fixed 40% SM share (-S)")
        if not use_matching:
            parts.append("greedy FIFO placement (-M)")
        self.description = ("MuxFlow space-sharing: dynamic SM + KM matching."
                            if not parts else
                            "MuxFlow ablation: " + ", ".join(parts) + ".")

    def scheduler_config(self, shard_size: int = 256) -> SchedulerConfig:
        return SchedulerConfig(use_dynamic_sm=self.use_dynamic_sm,
                               use_matching=self.use_matching,
                               shard_size=shard_size)

    def sm_shares(self, on, idx):
        if self.use_dynamic_sm:
            return dynamic_sm_array(on["sm_activity"][idx])
        return np.full(idx.shape, fixed_sm(), np.float64)

    def shared_performance(self, on, off, shares):
        return shared_performance_arrays(on, off, shares)


class TimeSharingPolicy(SharingPolicy):
    """Gandiva-style fair time-sharing: online and offline alternate slices.

    The offline workload holds the GPU roughly half the time, so the online
    workload stalls whenever it arrives during an offline slice — slowdown
    grows with online utilization (up to ~50 % in the paper, Fig. 11).
    """

    name = "time-sharing"
    description = ("Gandiva-style fair time slices: ~0.45x offline "
                   "throughput but online slows with load (up to ~50%).")
    off_duty = 0.5                 # offline's share of wall time

    def shared_performance(self, on, off, shares):
        slow = 1.0 + 0.9 * self.off_duty * np.minimum(1.0,
                                                      on["gpu_util"] * 2.2)
        n = on["gpu_util"].shape[0]
        return slow, np.full(n, self.off_duty * 0.9)


class PriorityTimeSharingPolicy(SharingPolicy):
    """AntMan/PAI-style priority-based time-sharing.

    Online has strict time priority; offline kernels fill only idle *time*,
    so online pays a small fixed context overhead and offline throughput
    tracks online idleness.
    """

    name = "pb-time-sharing"
    description = ("AntMan/PAI-style priority time-sharing: offline fills "
                   "idle time only; small fixed online overhead.")

    def shared_performance(self, on, off, shares):
        n = on["gpu_util"].shape[0]
        idle = np.maximum(0.0, 1.0 - on["gpu_util"])
        return np.full(n, 1.05), idle * 0.8


DEDICATED = register(DedicatedPolicy(), aliases=("dedicated",))
MUXFLOW = register(MuxFlowPolicy())
MUXFLOW_S = register(MuxFlowPolicy("muxflow-s", use_dynamic_sm=False,
                                   use_matching=True))
MUXFLOW_M = register(MuxFlowPolicy("muxflow-m", use_dynamic_sm=True,
                                   use_matching=False))
MUXFLOW_S_M = register(MuxFlowPolicy("muxflow-s-m", use_dynamic_sm=False,
                                     use_matching=False))
TIME_SHARING = register(TimeSharingPolicy())
PB_TIME_SHARING = register(PriorityTimeSharingPolicy())
