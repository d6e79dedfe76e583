"""Workload profiles: the predictor's view of a workload, copied from
`repro/core/interference.py` (the dataclass and the paper's four offline
model profiles; the closed-form contention model waits for the simulator).

The workload profile mirrors the paper's predictor features: GPU
utilization, SM activity, SM occupancy, and separate execution time.
"""
from __future__ import annotations

import dataclasses


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


# Profiles for the paper's four offline DL models (T4-class numbers).  Values
# follow the published relative speeds (VGG16 bandwidth-heavy, Inception
# compute-light, etc.).
OFFLINE_MODEL_PROFILES = {
    "ResNet50": WorkloadProfile("ResNet50", 0.95, 0.72, 0.55, 0.55, 180.0, 0.18),
    "VGG16": WorkloadProfile("VGG16", 0.97, 0.80, 0.60, 0.75, 300.0, 0.22),
    "DenseNet201": WorkloadProfile("DenseNet201", 0.93, 0.66, 0.45, 0.60, 260.0, 0.20),
    "Inception-V3": WorkloadProfile("Inception-V3", 0.90, 0.58, 0.42, 0.45, 210.0, 0.16),
}
