"""ArrivalProcess: seeded request arrivals, copied from
`repro/serving_plane/arrivals.py` for the `poisson` kind, the one the
pair-profiling harness rides (`profiling/harness.py:_arrivals`).  The other
kinds (diurnal, burst, trace replay) wait for the serving plane.

Determinism: every random draw goes through numpy's `SeedSequence`, so the
same (kind, params, seed) gives the same stream in every process, and
`times()` is bit-for-bit `repro`'s stream.
"""
from __future__ import annotations

import numpy as np

ARRIVAL_KINDS = ("poisson",)

# gap-sampling draws this multiple of the expected count per batch; the
# profiling harness's historical stream used exactly 2x (kept for artifact
# stability), topped up in the rare case the batch falls short of horizon
_GAP_BATCH_FACTOR = 2


def _rng(seed) -> np.random.Generator:
    """Seed an independent Generator from an int or a sequence of ints."""
    if isinstance(seed, (tuple, list)):
        return np.random.default_rng(np.random.SeedSequence(list(seed)))
    return np.random.default_rng(np.random.SeedSequence(seed))


class ArrivalProcess:
    """A seeded request-arrival process.  Build it with :meth:`poisson`."""

    def __init__(self, kind: str, *, seed=0, mean_gap: float | None = None):
        if kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"unknown arrival kind {kind!r}; available: {ARRIVAL_KINDS}")
        self.kind = kind
        self.seed = seed
        self.mean_gap = mean_gap

    @classmethod
    def poisson(cls, rate: float | None = None, *,
                mean_gap: float | None = None, seed=0) -> "ArrivalProcess":
        """Homogeneous Poisson process; give ``rate`` (arrivals per unit
        time) or ``mean_gap`` (its reciprocal, passed through exactly — the
        profiling harness's parameterization)."""
        if (rate is None) == (mean_gap is None):
            raise ValueError("give exactly one of rate / mean_gap")
        if mean_gap is None:
            mean_gap = 1.0 / rate
        if mean_gap <= 0:
            raise ValueError(f"mean_gap must be positive, got {mean_gap}")
        return cls("poisson", seed=seed, mean_gap=mean_gap)

    def times(self, horizon: float) -> np.ndarray:
        """Arrival timestamps in ``[0, horizon)``.  A pure function of
        (process, horizon): every call re-derives the stream from the seed
        (exponential gaps, cumulative sum)."""
        return self._gap_times(_rng(self.seed), self.mean_gap, horizon)

    @staticmethod
    def _gap_times(rng: np.random.Generator, mean_gap: float,
                   horizon: float) -> np.ndarray:
        size = max(int(_GAP_BATCH_FACTOR * horizon / mean_gap), 8)
        gaps = rng.exponential(mean_gap, size=size)
        times = np.cumsum(gaps)
        # top up in the (vanishingly rare, E[total] = 2×horizon) case the
        # batch falls short
        while times.size and times[-1] < horizon:
            more = np.cumsum(rng.exponential(mean_gap, size=size))
            times = np.concatenate([times, times[-1] + more])
        return times[times < horizon]
