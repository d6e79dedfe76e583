"""Dynamic SM allocation (§4.3, Fig. 8): the offline workload's SM share is
set complementary to the online workload's measured SM activity instead of a
fixed split — workload A at 20 % SM leaves 80 % for its offline partner,
workload B at 80 % leaves 20 %.

Copied from `repro/core/dynamic_sm.py` with the same arithmetic.
"""
from __future__ import annotations

import numpy as np


def _check_band(floor: float, cap: float, step: float) -> None:
    if not floor <= cap:
        raise ValueError(f"floor {floor} > cap {cap}")
    if not np.isfinite(step):
        raise ValueError(f"step must be finite, got {step}")


def dynamic_sm(online_sm_activity: float, *, headroom: float = 0.05,
               floor: float = 0.1, cap: float = 0.9,
               step: float = 0.1) -> float:
    """Complementary share: 1 − a_on − headroom, clipped to [floor, cap] and
    quantized to MPS-style `step` increments
    (CUDA_MPS_ACTIVE_THREAD_PERCENTAGE granularity).

    The result always lies in [floor, cap]; when quantization pushes the
    share past a band edge the edge wins, so with a band edge off the step
    grid the returned share can sit on the edge rather than the grid.
    """
    _check_band(floor, cap, step)
    share = 1.0 - float(online_sm_activity) - headroom
    share = max(floor, min(cap, share))
    if step > 0:
        share = round(share / step) * step
    return max(floor, min(cap, share))


def dynamic_sm_array(online_sm_activity, *, headroom: float = 0.05,
                     floor: float = 0.1, cap: float = 0.9,
                     step: float = 0.1) -> np.ndarray:
    """Vectorized :func:`dynamic_sm` over a fleet's activity array.  Mirrors
    the scalar operation order (same clip → half-even round → clip), so each
    element is bitwise-identical to the scalar call — pinned by a property
    test."""
    _check_band(floor, cap, step)
    share = 1.0 - np.asarray(online_sm_activity, np.float64) - headroom
    share = np.clip(share, floor, cap)
    if step > 0:
        share = np.round(share / step) * step
    return np.clip(share, floor, cap)


def fixed_sm(share: float = 0.4) -> float:
    """The MuxFlow-S ablation baseline: a fixed offline SM share."""
    return share
