"""Request arrival times of a traffic mix.

`process_times` is a copy of the port's `serving_plane/arrivals.py`
(`ArrivalProcess.times` for its `poisson` and `burst` kinds, with its
gap-sampling stream), kept here so that the traffic cannot move with the
program.  `arrival_times` draws that process once from the mix's fixed
`base_seed`, then orders the gaps of each segment (the whole window for
`poisson`; each burst and each calm stretch for `burst`) by the run's
seed: every seed offers the same number of requests in the same segments,
so seeds differ in when requests come and not in how much work a run has.
"""
from __future__ import annotations

import numpy as np

from muxbench.weights import TAGS

_GAP_BATCH_FACTOR = 2


def _rng(seed) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed))


def _gap_times(rng, mean_gap: float, horizon: float) -> np.ndarray:
    size = max(int(_GAP_BATCH_FACTOR * horizon / mean_gap), 8)
    times = np.cumsum(rng.exponential(mean_gap, size=size))
    while times.size and times[-1] < horizon:
        more = np.cumsum(rng.exponential(mean_gap, size=size))
        times = np.concatenate([times, times[-1] + more])
    return times[times < horizon]


def process_times(spec: dict, seed: int, horizon: float) -> np.ndarray:
    """Arrival times in [0, horizon) of the process `spec`: {"kind":
    "poisson", "rate"} or {"kind": "burst", "rate", "mult", "period_s",
    "burst_len_s"} (the burst window at the start of every period)."""
    rng = _rng(seed)
    if spec["kind"] == "poisson":
        return _gap_times(rng, 1.0 / spec["rate"], horizon)
    if spec["kind"] == "burst":
        base = spec["rate"]
        peak = base * max(spec["mult"], 1.0)
        cand = _gap_times(rng, 1.0 / peak, horizon)
        in_burst = (cand % spec["period_s"]) < spec["burst_len_s"]
        local = np.where(in_burst, base * spec["mult"], base)
        keep = rng.random(cand.size) * peak <= local
        return cand[keep]
    raise ValueError(f"unknown arrival kind {spec['kind']!r}")


def segments(spec: dict, horizon: float) -> list[tuple[float, float]]:
    """The stretches of [0, horizon) whose gaps may be reordered."""
    if spec["kind"] != "burst":
        return [(0.0, horizon)]
    cuts = {0.0, horizon}
    t = 0.0
    while t < horizon:
        cuts.update({t, min(t + spec["burst_len_s"], horizon)})
        t += spec["period_s"]
    cuts = sorted(c for c in cuts if c <= horizon)
    return list(zip(cuts[:-1], cuts[1:]))


def arrival_times(spec: dict, seed: int, horizon: float) -> np.ndarray:
    """The mix's arrivals in [0, horizon) for the run's seed, sorted."""
    base = process_times(spec, spec["base_seed"], horizon)
    rng = _rng([seed % 2 ** 64, TAGS["arrivals"]])
    out = []
    for a, b in segments(spec, horizon):
        ts = base[(base >= a) & (base < b)]
        if ts.size:
            gaps = np.diff(np.concatenate([[a], ts]))
            out.append(a + np.cumsum(rng.permutation(gaps)))
    return np.concatenate(out) if out else np.empty(0)
