"""New sharing policies from related work, built purely on the policy API.

Neither of these touches the simulator engine: a new baseline is one
registered :class:`~repro_torch.policies.base.SharingPolicy` class.  Copied
from `repro/policies/extra.py`.

* ``tally-priority`` — Tally-style priority task-slicing (PAPERS.md:
  "Tally: Non-Intrusive Performance Isolation for Concurrent DL
  Workloads").  Best-effort kernels are sliced and admitted only in
  priority-gated slack windows, so online interference is near zero by
  construction, at the cost of offline throughput.
* ``static-partition`` — ParvaGPU-style static spatial partitioning
  (PAPERS.md: "ParvaGPU: Efficient Spatial GPU Sharing").  A fixed
  MIG-like SM split hard-isolates the pair: offline gets a constant,
  predictable slice; online suffers only when its instantaneous demand
  spills past its own partition.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.interference import instantaneous_sm_demand
from repro_torch.policies.base import SharingPolicy, register


def _inst_demand(on: dict[str, np.ndarray]) -> np.ndarray:
    """Online instantaneous SM demand (the interference model's own
    duty-cycle correction)."""
    return instantaneous_sm_demand(on["sm_activity"], on["gpu_util"])


class TallyPriorityPolicy(SharingPolicy):
    """Priority task-slicing: offline work admitted in slack slices only.

    The scheduler slices best-effort kernels into short launch quanta and
    gates each quantum on the online workload's instantaneous occupancy, so
    the online workload almost never waits behind offline work — slowdown
    stays within the slicing instrumentation overhead.  Offline throughput
    is whatever fits in the gated slices: idle time plus the spatial slack
    left during online kernels, discounted by slicing efficiency.
    """

    name = "tally-priority"
    description = ("Tally-style priority task-slicing: near-zero online "
                   "slowdown, offline rides priority-gated slack slices.")
    slice_share = 0.25             # SM quota a slice may occupy (placement)
    overhead = 0.02                # worst-case slowdown from slicing
    idle_eff = 0.70                # slice efficiency in fully idle time
    slack_eff = 0.30               # slice efficiency inside spatial slack

    def sm_shares(self, on, idx):
        return np.full(idx.shape, self.slice_share, np.float64)

    def shared_performance(self, on, off, shares):
        util = on["gpu_util"]
        # instrumentation + gating checks scale with how often online runs
        slow = 1.0 + self.overhead * util
        idle = np.maximum(0.0, 1.0 - util)
        slack = np.maximum(0.0, 1.0 - _inst_demand(on))
        tput = self.idle_eff * idle + self.slack_eff * util * slack
        return slow, np.clip(tput, 0.0, 1.0)


class StaticPartitionPolicy(SharingPolicy):
    """Fixed MIG-like SM split: hard spatial isolation, zero elasticity.

    The device is carved once: ``partition`` of the SMs go to the offline
    tenant, the rest to online.  Isolation means offline throughput is a
    constant fraction of demand (no cross-tenant contention), but the online
    workload is capped at its own partition — when its instantaneous demand
    spills past that cap it queues on its own slice and slows down.
    """

    name = "static-partition"
    description = ("ParvaGPU-style static MIG-like SM split: predictable "
                   "offline slice, online capped at its partition.")
    partition = 0.5                # offline's fixed SM fraction
    isolation_eff = 0.95           # partition/reconfiguration overhead

    def sm_shares(self, on, idx):
        return np.full(idx.shape, self.partition, np.float64)

    def shared_performance(self, on, off, shares):
        on_cap = 1.0 - self.partition
        # online queues on its own slice when demand exceeds the partition
        spill = np.maximum(0.0, _inst_demand(on) - on_cap) / max(on_cap, 1e-6)
        slow = 1.0 + 0.8 * spill * on["gpu_util"]
        used = np.minimum(self.partition, off["sm_activity"])
        tput = self.isolation_eff * used / np.maximum(off["sm_activity"],
                                                      1e-6)
        return slow, np.clip(tput, 0.0, 1.0)


TALLY_PRIORITY = register(TallyPriorityPolicy())
STATIC_PARTITION = register(StaticPartitionPolicy())
