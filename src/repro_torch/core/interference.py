"""Space-sharing interference model — the simulator's ground truth.

On real hardware this is what DCGM measures; here it is an analytic model of
SM and memory-bandwidth contention calibrated against the paper's Figure 4:

  * Fig 4(a): with a tuned SM split, one T4 yields up to +62 % extra offline
    compute while slowing the online workload < 20 %.
  * Fig 4(b): sweeping the offline SM share 10 %→100 % moves both workloads'
    normalized performance by > 5×.

The workload profile mirrors the paper's predictor features: GPU utilization,
SM activity, SM occupancy, and separate execution time.

This model is the *synthetic* ground truth.  Its measured counterpart —
:class:`repro_torch.profiling.calibrate.MeasuredInterferenceProvider`, built from
executed workload pairs — is call-compatible with
:func:`shared_performance_arrays` and backs the ``muxflow-measured``
policy.

Copied from `repro/core/interference.py` operation for operation, so
both packages' simulators see bitwise-equal ground truth.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Separate-execution profile (what the workload profiler measures)."""
    name: str
    gpu_util: float        # time-occupancy in [0,1]
    sm_activity: float     # space-occupancy in [0,1] (peak SM demand)
    sm_occupancy: float    # per-SM warp occupancy in [0,1]
    mem_bw: float          # HBM bandwidth fraction in [0,1]
    exec_time_ms: float    # iteration (or request) latency running alone
    mem_bytes_frac: float = 0.3   # GPU memory footprint fraction


# Model constants (calibrated against the paper's Fig. 4)
_SM_CONTENTION = 0.25      # online slowdown per unit instantaneous SM overlap
_BW_CONTENTION = 0.35      # slowdown per unit memory-bandwidth oversubscription
_MPS_OVERHEAD = 0.02       # fixed MPS time-slicing overhead when shared
_BASE_CONTENTION = 0.10    # cache/scheduler interference ~ offline SM use
_OFF_BW_SENS = 0.45        # offline sensitivity to bandwidth contention
_OFF_OVERLAP_SENS = 0.35   # offline tput loss per unit instantaneous overlap


def shared_performance(online: WorkloadProfile, offline: WorkloadProfile,
                       sm_off: float) -> tuple[float, float]:
    """Returns (online_slowdown >= 1, offline_norm_tput in [0,1]) when the
    pair shares one GPU with `sm_off` SM fraction assigned to the offline
    workload (CUDA_MPS_ACTIVE_THREAD_PERCENTAGE analogue)."""
    sm_off = float(np.clip(sm_off, 0.0, 1.0))
    a_on = online.sm_activity                     # time-avg SM demand
    used_off = min(sm_off, offline.sm_activity)   # offline uses what it needs
    # while an online kernel is executing, its instantaneous SM demand is
    # duty-cycle corrected (avg activity / time occupancy)
    inst_on = min(1.0, a_on / max(online.gpu_util, 0.05))
    overlap_inst = max(0.0, inst_on + used_off - 1.0)
    overlap_avg = overlap_inst * online.gpu_util
    # memory bandwidth contention
    bw_off = offline.mem_bw * (used_off / max(offline.sm_activity, 1e-6))
    bw_over = max(0.0, online.mem_bw * online.gpu_util + bw_off - 1.0)
    # used_off^1.5 spelled as x*sqrt(x): sqrt is IEEE-correctly-rounded on
    # every backend (numpy, torch), unlike libm pow — this keeps the
    # tick engines bitwise-aligned
    online_slowdown = (1.0 + _MPS_OVERHEAD
                       + _BASE_CONTENTION * used_off * np.sqrt(used_off)
                       + _SM_CONTENTION * overlap_inst / max(inst_on, 0.05)
                       + _BW_CONTENTION * bw_over / max(online.mem_bw, 0.05))
    # offline throughput: what it gets of its demand, minus contention losses
    eff = used_off - 0.5 * overlap_avg
    tput = eff / max(offline.sm_activity, 1e-6)
    tput *= 1.0 / (1.0 + _OFF_OVERLAP_SENS * overlap_inst
                   + _OFF_BW_SENS * bw_over / max(offline.mem_bw, 0.05))
    tput *= (1.0 - _MPS_OVERHEAD)
    return float(online_slowdown), float(np.clip(tput, 0.0, 1.0))


def memory_feasible(online: WorkloadProfile, offline: WorkloadProfile,
                    quota: float = 0.4) -> bool:
    """xCUDA memory-quota check: offline must fit its quota AND the sum must
    fit the device (the paper fixes the offline quota to 40 %)."""
    return (offline.mem_bytes_frac <= quota
            and online.mem_bytes_frac + offline.mem_bytes_frac <= 0.98)


def qps_to_activity(qps: float, qps_capacity: float, peak_sm: float) -> float:
    """Map request rate to online SM activity (saturating)."""
    x = qps / max(qps_capacity, 1e-6)
    return peak_sm * (1.0 - math.exp(-1.6 * x))


# Profiles for the paper's four offline DL models (T4-class numbers) plus a
# few online-service archetypes.  Values follow the published relative speeds
# (VGG16 bandwidth-heavy, Inception compute-light, etc.).
OFFLINE_MODEL_PROFILES = {
    "ResNet50": WorkloadProfile("ResNet50", 0.95, 0.72, 0.55, 0.55, 180.0, 0.18),
    "VGG16": WorkloadProfile("VGG16", 0.97, 0.80, 0.60, 0.75, 300.0, 0.22),
    "DenseNet201": WorkloadProfile("DenseNet201", 0.93, 0.66, 0.45, 0.60, 260.0, 0.20),
    "Inception-V3": WorkloadProfile("Inception-V3", 0.90, 0.58, 0.42, 0.45, 210.0, 0.16),
}

# Calibrated so the online-only fleet averages match the paper's Fig. 15
# baselines: GPU util ~26 %, SM activity ~16 %, memory ~42 %.
ONLINE_SERVICE_PROFILES = {
    "recommend": dict(peak_sm=0.30, mem_bw=0.35, qps_capacity=150.0,
                      base_latency_ms=38.0, mem_bytes_frac=0.42),
    "translate": dict(peak_sm=0.38, mem_bw=0.42, qps_capacity=90.0,
                      base_latency_ms=55.0, mem_bytes_frac=0.45),
    "vision": dict(peak_sm=0.46, mem_bw=0.48, qps_capacity=60.0,
                   base_latency_ms=70.0, mem_bytes_frac=0.40),
}


def online_profile_consts(service_idx: np.ndarray,
                          services: tuple[str, ...]) -> dict[str, np.ndarray]:
    """Per-device service-constant gathers for :func:`online_profile_arrays`.

    ``service_idx`` is fixed for a fleet's lifetime, so engines compute this
    once instead of re-gathering five constant arrays every tick."""
    def const(key):
        return np.array([ONLINE_SERVICE_PROFILES[s][key] for s in services],
                        np.float64)[service_idx]

    consts = {k: const(k) for k in ("qps_capacity", "peak_sm", "mem_bw",
                                    "base_latency_ms", "mem_bytes_frac")}
    for arr in consts.values():
        # these arrays are cached for a fleet's lifetime and two of them
        # are handed out verbatim every tick (exec_time_ms,
        # mem_bytes_frac); freeze them so a misbehaving policy mutating
        # its inputs fails loudly instead of corrupting every later tick
        arr.flags.writeable = False
    return consts


def online_profile_arrays(service_idx: np.ndarray, qps: np.ndarray,
                          services: tuple[str, ...],
                          consts: dict[str, np.ndarray] | None = None,
                          ) -> dict[str, np.ndarray]:
    """Vectorized :func:`online_profile` over a fleet.

    ``service_idx[i]`` indexes into ``services``; returns a dict of per-device
    arrays with the same fields as :class:`WorkloadProfile`.  The arithmetic
    mirrors the scalar function operation-for-operation so values agree
    bitwise with per-device calls.  Pass a precomputed ``consts`` (from
    :func:`online_profile_consts`) to skip the per-call constant gathers on
    hot paths — the values are identical either way.
    """
    if consts is None:
        consts = online_profile_consts(service_idx, services)
    cap = consts["qps_capacity"]
    peak = consts["peak_sm"]
    x = qps / cap
    act = peak * (1.0 - np.exp(-1.6 * (qps / np.maximum(cap, 1e-6))))
    util = np.clip(0.08 + 0.40 * x, 0.0, 1.0)
    return {
        "gpu_util": util,
        "sm_activity": act,
        "sm_occupancy": 0.35 + 0.3 * act,
        "mem_bw": consts["mem_bw"] * util,
        "exec_time_ms": consts["base_latency_ms"],
        "mem_bytes_frac": consts["mem_bytes_frac"],
    }


def instantaneous_sm_demand(sm_activity: np.ndarray,
                            gpu_util: np.ndarray) -> np.ndarray:
    """Duty-cycle-corrected instantaneous SM demand: while a kernel is
    executing, its SM demand is the time-averaged activity divided by the
    time occupancy (floored at 0.05), capped at 1.  The single home for this
    correction — the interference model and the sharing policies that reason
    about spatial slack (tally-priority, static-partition) all use it."""
    return np.minimum(1.0, sm_activity / np.maximum(gpu_util, 0.05))


def shared_performance_arrays(on: dict[str, np.ndarray],
                              off: dict[str, np.ndarray],
                              sm_off: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`shared_performance`: elementwise over per-device
    online/offline profile arrays.  Mirrors the scalar operation order."""
    sm_off = np.clip(sm_off, 0.0, 1.0)
    a_on = on["sm_activity"]
    used_off = np.minimum(sm_off, off["sm_activity"])
    inst_on = instantaneous_sm_demand(a_on, on["gpu_util"])
    overlap_inst = np.maximum(0.0, inst_on + used_off - 1.0)
    overlap_avg = overlap_inst * on["gpu_util"]
    bw_off = off["mem_bw"] * (used_off / np.maximum(off["sm_activity"], 1e-6))
    bw_over = np.maximum(0.0, on["mem_bw"] * on["gpu_util"] + bw_off - 1.0)
    online_slowdown = (1.0 + _MPS_OVERHEAD
                       + _BASE_CONTENTION * used_off * np.sqrt(used_off)
                       + _SM_CONTENTION * overlap_inst / np.maximum(inst_on, 0.05)
                       + _BW_CONTENTION * bw_over / np.maximum(on["mem_bw"], 0.05))
    eff = used_off - 0.5 * overlap_avg
    tput = eff / np.maximum(off["sm_activity"], 1e-6)
    tput = tput * (1.0 / (1.0 + _OFF_OVERLAP_SENS * overlap_inst
                          + _OFF_BW_SENS * bw_over / np.maximum(off["mem_bw"], 0.05)))
    tput = tput * (1.0 - _MPS_OVERHEAD)
    return online_slowdown, np.clip(tput, 0.0, 1.0)


def offline_profile_arrays(model_idx: np.ndarray,
                           models: tuple[str, ...]) -> dict[str, np.ndarray]:
    """Per-device offline profile arrays from a model-index array (devices
    without a job may carry any index; mask downstream)."""
    def const(attr):
        return np.array([getattr(OFFLINE_MODEL_PROFILES[m], attr)
                         for m in models], np.float64)[model_idx]

    return {k: const(k) for k in ("gpu_util", "sm_activity", "sm_occupancy",
                                  "mem_bw", "exec_time_ms", "mem_bytes_frac")}


def online_profile(service: str, qps: float) -> WorkloadProfile:
    s = ONLINE_SERVICE_PROFILES[service]
    x = qps / s["qps_capacity"]
    act = qps_to_activity(qps, s["qps_capacity"], s["peak_sm"])
    util = float(np.clip(0.08 + 0.40 * x, 0.0, 1.0))
    return WorkloadProfile(
        name=service, gpu_util=util, sm_activity=act,
        sm_occupancy=0.35 + 0.3 * act, mem_bw=s["mem_bw"] * util,
        exec_time_ms=s["base_latency_ms"], mem_bytes_frac=s["mem_bytes_frac"])
