"""Matching-based scheduling (§5, Algorithm 1) and the global manager.

Every scheduling interval: build the bipartite graph between online workloads
(one per shareable GPU) and pending/running offline workloads; edge weight =
speed-predictor normalized throughput at the dynamic-SM share; solve with KM;
apply the matching (with move = checkpoint + restart semantics handled by the
caller/simulator).  Devices whose SysMonitor is not Healthy contribute no
node — this is also how elasticity works: the graph is simply rebuilt from
the live device set, so node joins/leaves are absorbed at the next interval.

Paper-scale path: offline jobs carry one of a handful of distinct profiles,
so the weight matrix has only ``n_slots × n_unique_profiles`` distinct
entries.  Prediction is batched over that grid (one predictor call per GPU
type instead of one per pair), and when the bipartite problem exceeds
``shard_size`` the matcher switches from dense KM to
:func:`repro_torch.core.matching.sharded_match_compact`, which partitions
devices/jobs into bounded shards (the paper schedules per cluster partition
anyway) and prunes near-zero edges — O(shards · s³) instead of O(n³).

Copied from `repro/core/scheduler.py`.  The predictor it calls is the
port's: its MLP answers the weight grid on the device that holds it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dynamic_sm import dynamic_sm, fixed_sm
from repro_torch.core.interference import WorkloadProfile
from repro_torch.core.matching import km_match, sharded_match_compact
from repro_torch.core.predictor import N_FEATURES, SpeedPredictor


@dataclasses.dataclass
class OnlineSlot:
    """A shareable GPU running one online workload."""
    device_id: int
    gpu_type: str
    profile: WorkloadProfile


@dataclasses.dataclass
class OfflineJob:
    job_id: int
    profile: WorkloadProfile
    remaining_iters: float


@dataclasses.dataclass
class Assignment:
    device_id: int
    job_id: int
    sm_share: float
    predicted_tput: float


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    use_dynamic_sm: bool = True     # False => MuxFlow-S ablation (fixed 40 %)
    use_matching: bool = True       # False => MuxFlow-M ablation (greedy FIFO)
    fixed_sm_share: float = 0.4
    min_weight: float = 0.02        # prune edges below this predicted tput
    shard_size: int = 256           # partition bound for paper-scale matching
    row_slack: int = 16             # extra devices kept per shard model group


def _sm_share(cfg: SchedulerConfig, online: WorkloadProfile) -> float:
    if cfg.use_dynamic_sm:
        return dynamic_sm(online.sm_activity)
    return fixed_sm(cfg.fixed_sm_share)


def build_online_slots(free_idx, gpu_type: list[str], service_idx,
                       on: dict, services: tuple[str, ...],
                       ) -> list[OnlineSlot]:
    """Materialize :class:`OnlineSlot` objects for the free devices of a
    fleet from vectorized online-profile arrays (see
    :func:`repro_torch.core.interference.online_profile_arrays`).  Shared by the
    simulator engine and external callers."""
    return [
        OnlineSlot(int(i), gpu_type[i], WorkloadProfile(
            name=services[service_idx[i]],
            gpu_util=float(on["gpu_util"][i]),
            sm_activity=float(on["sm_activity"][i]),
            sm_occupancy=float(on["sm_occupancy"][i]),
            mem_bw=float(on["mem_bw"][i]),
            exec_time_ms=float(on["exec_time_ms"][i]),
            mem_bytes_frac=float(on["mem_bytes_frac"][i])))
        for i in free_idx]


def job_groups(jobs: list[OfflineJob]) -> tuple[np.ndarray,
                                                list[WorkloadProfile]]:
    """Group jobs by (identical) offline profile: (col_group (m,), uniq)."""
    group_of: dict[WorkloadProfile, int] = {}
    col_group = np.empty(len(jobs), np.int64)
    uniq: list[WorkloadProfile] = []
    for j, jb in enumerate(jobs):
        g = group_of.get(jb.profile)
        if g is None:
            g = group_of[jb.profile] = len(uniq)
            uniq.append(jb.profile)
        col_group[j] = g
    return col_group, uniq


def build_weight_grid_arrays(gpu_types: list[str], on_feats: np.ndarray,
                             shares: np.ndarray, jobs: list[OfflineJob],
                             predictor: SpeedPredictor, cfg: SchedulerConfig,
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Array-native batched prediction over the (slot × unique offline
    profile) grid — the engines' hot path (no per-slot Python objects).

    ``gpu_types`` is the per-slot GPU type, ``on_feats`` the (n, 4) float32
    online feature block (util, activity, occupancy, exec seconds), and
    ``shares`` the per-slot offline SM share.  Returns ``(values (n, u),
    col_group (m,))``.  One predictor call per GPU type; cost is O(n · u)
    instead of O(n · m) — with the paper's four offline models u = 4
    regardless of queue depth.
    """
    n, m = len(gpu_types), len(jobs)
    col_group, uniq = job_groups(jobs)
    u = len(uniq)
    off_feats = np.array([[p.gpu_util, p.sm_activity, p.sm_occupancy,
                           p.exec_time_ms / 1000.0] for p in uniq],
                         np.float32)
    values = np.zeros((n, u), np.float64)
    shares32 = shares.astype(np.float32)
    gpu_types_arr = np.asarray(gpu_types)
    # distinct types in first-occurrence order, without a Python iteration
    # over every slot
    uniq_types, first = np.unique(gpu_types_arr, return_index=True)
    for gpu_type in uniq_types[np.argsort(first)]:
        idxs = np.flatnonzero(gpu_types_arr == gpu_type)
        k = len(idxs)
        feats = np.empty((k, u, N_FEATURES), np.float32)
        feats[:, :, 0:4] = on_feats[idxs][:, None, :]
        feats[:, :, 4:8] = off_feats[None, :, :]
        feats[:, :, 8] = shares32[idxs][:, None]
        pred = predictor.predict(gpu_type, feats.reshape(k * u, N_FEATURES))
        values[idxs] = pred.reshape(k, u)
    values[values < cfg.min_weight] = 0.0
    return values, col_group


def static_weight_grid(shares: np.ndarray, jobs: list[OfflineJob],
                       cfg: SchedulerConfig) -> tuple[np.ndarray, np.ndarray]:
    """Predictor-free fallback grid — the degradation-ladder rung for a
    speed-predictor outage.

    Uses the §4.3 static share table alone: an offline partner granted SM
    share ``s`` is assumed to run at roughly ``1 − 0.6·s`` of solo speed
    (the calibrated average contention slope), identically for every
    offline profile.  Placement quality drops to "any job on the least
    contended device", but scheduling rounds keep running — no predictor
    call is made.  Same ``(values (n, u), col_group (m,))`` contract as
    :func:`build_weight_grid_arrays`.
    """
    col_group, uniq = job_groups(jobs)
    u = max(1, len(uniq))
    col = np.maximum(cfg.min_weight, 1.0 - 0.6 * shares.astype(np.float64))
    return np.tile(col[:, None], (1, u)), col_group


def build_weight_grid(slots: list[OnlineSlot], jobs: list[OfflineJob],
                      predictor: SpeedPredictor, cfg: SchedulerConfig,
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Slot-object wrapper over :func:`build_weight_grid_arrays` (kept for
    the reference engine and external callers; the numerics live in the
    array-native core, so both paths produce identical grids)."""
    shares = np.array([_sm_share(cfg, s.profile) for s in slots], np.float64)
    on_feats = np.array([[s.profile.gpu_util, s.profile.sm_activity,
                          s.profile.sm_occupancy,
                          s.profile.exec_time_ms / 1000.0]
                         for s in slots], np.float32)
    values, col_group = build_weight_grid_arrays(
        [s.gpu_type for s in slots], on_feats, shares, jobs, predictor, cfg)
    return values, col_group, shares


def solve_matching(values: np.ndarray, col_group: np.ndarray,
                   cfg: SchedulerConfig, *, row_ids: np.ndarray | None = None,
                   matcher=None) -> list[tuple[int, int]]:
    """The matching step of Algorithm 1 on a compact weight grid.

    Small problems solve dense exact KM; larger ones go through the
    partitioned matcher — warm-started via ``matcher`` (an
    :class:`repro_torch.core.matching.IncrementalMatcher`, exact by construction)
    when one is supplied, cold otherwise.
    """
    n, m = values.shape[0], col_group.shape[0]
    if not cfg.use_matching:
        # MuxFlow-M ablation: FIFO jobs onto arbitrary (first) free devices
        return [(i, i) for i in range(min(n, m))
                if values[i, col_group[i]] > 0]
    if max(n, m) <= cfg.shard_size:
        return km_match(values[:, col_group])           # dense exact KM
    if matcher is not None:
        if row_ids is None:
            row_ids = np.arange(n)
        return matcher.match(values, col_group, row_ids,
                             shard_size=cfg.shard_size,
                             row_slack=cfg.row_slack)
    return sharded_match_compact(values, col_group,
                                 shard_size=cfg.shard_size,
                                 row_slack=cfg.row_slack)


def schedule(slots: list[OnlineSlot], jobs: list[OfflineJob],
             predictor: SpeedPredictor,
             cfg: SchedulerConfig = SchedulerConfig(),
             matcher=None) -> list[Assignment]:
    """Algorithm 1.  Returns the chosen assignments."""
    if not slots or not jobs:
        return []
    values, col_group, shares = build_weight_grid(slots, jobs, predictor, cfg)
    row_ids = np.array([s.device_id for s in slots], np.int64)
    pairs = solve_matching(values, col_group, cfg, row_ids=row_ids,
                           matcher=matcher)
    return [Assignment(device_id=slots[i].device_id, job_id=jobs[j].job_id,
                       sm_share=float(shares[i]),
                       predicted_tput=float(values[i, col_group[j]]))
            for i, j in pairs]
