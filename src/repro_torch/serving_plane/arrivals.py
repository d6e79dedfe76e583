"""ArrivalProcess — the one shared definition of "requests arrive".

The repo had grown two arrival implementations: the pair-profiling
harness's seeded Poisson stream (``profiling/harness.py``) and the ad-hoc
exponential-gap loop in ``examples/serve_multiplex.py`` — while the cluster
sim modeled online load as a QPS *curve* (:class:`repro_torch.core.traces.QPSBank`)
with no requests at all.  This module unifies the three: one seeded process
object with two consumption surfaces,

* :meth:`times` / :meth:`first_n` — per-request timestamps, for
  request-level consumers (the pair profiler's quantum loop, the §4.2
  multiplexer demo, property tests);
* :meth:`counts_at` — per-tick arrival *counts* drawn in tick order, for
  fleet-scale consumers (the cluster :class:`~repro_torch.serving_plane.plane.
  ServingPlane`, where per-service rates reach tens of thousands of
  requests per second and individual timestamps would not fit in memory).

Kinds
-----
``poisson``
    Homogeneous rate.  ``times()`` reproduces the profiling harness's exact
    gap-sampling stream (``rng.exponential`` gaps, cumulative sum) so the
    speed-matrix artifact is unchanged by the migration.
``diurnal``
    Inhomogeneous rate driven by a ``rate_fn(t)``; :meth:`from_qps_bank`
    builds the canonical one — ``scale × bank.qps(t)[mask].sum()`` — so the
    serving plane's request stream and the sim's QPS curve are one
    definition (``rate()`` parity with :class:`QPSBank` is pinned by a
    property test).
``burst``
    Homogeneous base rate with periodic burst windows (``× mult``) — the
    paper's "online requests may suddenly burst".
``trace-replay``
    Replays an explicit, sorted timestamp array (e.g. a Philly-style skewed
    request trace from :func:`repro_torch.core.traces.philly_request_times`).

Determinism: every random draw goes through ``numpy``'s ``SeedSequence`` —
no builtin ``hash()`` — so the same (kind, params, seed) produces the same
stream in every process.  ``counts_at`` is a *stream* (one Poisson draw per
call, in tick order); :meth:`reset` rewinds it for replay.

Copied from `repro/serving_plane/arrivals.py` with the same behaviour.
"""
from __future__ import annotations

import numpy as np

ARRIVAL_KINDS = ("poisson", "diurnal", "trace-replay", "burst")

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
    """A seeded request-arrival process (see module docstring).

    Build through the classmethod constructors (:meth:`poisson`,
    :meth:`diurnal`, :meth:`from_qps_bank`, :meth:`burst`,
    :meth:`trace_replay`) rather than ``__init__``.
    """

    def __init__(self, kind: str, *, seed=0, mean_gap: float | None = None,
                 rate_fn=None, times: np.ndarray | None = None,
                 burst_mult: float = 1.0, burst_period_s: float = 0.0,
                 burst_len_s: float = 0.0):
        if kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"unknown arrival kind {kind!r}; available: {ARRIVAL_KINDS}")
        self.kind = kind
        self.seed = seed
        self.mean_gap = mean_gap
        self._rate_fn = rate_fn
        self._times = times
        self.burst_mult = burst_mult
        self.burst_period_s = burst_period_s
        self.burst_len_s = burst_len_s
        self.reset()

    # ------------------------------------------------------------ builders
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

    @classmethod
    def diurnal(cls, rate_fn, *, seed=0) -> "ArrivalProcess":
        """Inhomogeneous Poisson process with rate ``rate_fn(t)`` (arrivals
        per unit time)."""
        return cls("diurnal", seed=seed, rate_fn=rate_fn)

    @classmethod
    def from_qps_bank(cls, bank, *, mask=None, scale: float = 1.0,
                      seed=0) -> "ArrivalProcess":
        """The canonical diurnal process: rate(t) = ``scale ×
        bank.qps(t)[mask].sum()`` — arrivals follow the exact QPS curve the
        simulator engines read, so the request stream and the proxy load
        are one definition (parity is pinned by a property test)."""
        if mask is not None:
            mask = np.asarray(mask, bool)

        def rate_fn(t, _bank=bank, _mask=mask, _scale=scale):
            row = _bank.qps(t)
            if _mask is not None:
                row = row[_mask]
            return _scale * float(row.sum())

        return cls.diurnal(rate_fn, seed=seed)

    @classmethod
    def burst(cls, rate: float, *, mult: float = 3.0,
              period_s: float = 3600.0, burst_len_s: float = 300.0,
              seed=0) -> "ArrivalProcess":
        """Base rate with a burst window (``rate × mult``) of
        ``burst_len_s`` at the start of every ``period_s``."""
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        return cls("burst", seed=seed, mean_gap=1.0 / rate, burst_mult=mult,
                   burst_period_s=period_s, burst_len_s=burst_len_s)

    @classmethod
    def trace_replay(cls, times) -> "ArrivalProcess":
        """Replay an explicit arrival-timestamp array (sorted copy taken)."""
        times = np.sort(np.asarray(times, np.float64))
        return cls("trace-replay", times=times)

    # ---------------------------------------------------------------- rate
    def rate(self, t: float) -> float:
        """Expected arrivals per unit time at time ``t``."""
        if self.kind == "poisson":
            return 1.0 / self.mean_gap
        if self.kind == "diurnal":
            return float(self._rate_fn(t))
        if self.kind == "burst":
            base = 1.0 / self.mean_gap
            if self.burst_period_s > 0 and \
                    (t % self.burst_period_s) < self.burst_len_s:
                return base * self.burst_mult
            return base
        # trace-replay: the empirical mean rate over the trace span
        ts = self._times
        if ts.size < 2:
            return 0.0
        span = float(ts[-1] - ts[0])
        return ts.size / span if span > 0 else 0.0

    # -------------------------------------------------------------- counts
    def reset(self) -> None:
        """Rewind the :meth:`counts_at` stream (replay from the start)."""
        self._stream = (None if self.kind == "trace-replay"
                        else _rng(self.seed))

    def counts_at(self, t: float, dt: float) -> int:
        """Arrivals in ``[t, t + dt)``.  For random kinds this is a
        *streaming* draw — call in tick order (and :meth:`reset` to replay);
        for ``trace-replay`` it is a pure window count."""
        if self.kind == "trace-replay":
            lo = int(np.searchsorted(self._times, t, side="left"))
            hi = int(np.searchsorted(self._times, t + dt, side="left"))
            return hi - lo
        lam = self.rate(t) * dt
        return int(self._stream.poisson(lam)) if lam > 0 else 0

    # --------------------------------------------------------------- times
    def times(self, horizon: float) -> np.ndarray:
        """Arrival timestamps in ``[0, horizon)``.  A pure function of
        (process, horizon): every call re-derives the stream from the seed.

        For ``poisson`` this is the profiling harness's historical
        gap-sampling stream bit-for-bit (same ``SeedSequence``, same batch
        size, same cumulative sum); ``diurnal``/``burst`` use thinning
        against the kind's peak rate; ``trace-replay`` returns the trace.
        """
        if self.kind == "trace-replay":
            ts = self._times
            return ts[ts < horizon].copy()
        rng = _rng(self.seed)
        if self.kind == "poisson":
            return self._gap_times(rng, self.mean_gap, horizon)
        if self.kind == "burst":
            base = 1.0 / self.mean_gap
            peak = base * max(self.burst_mult, 1.0)
            cand = self._gap_times(rng, 1.0 / peak, horizon)
            in_burst = (self.burst_period_s > 0) & (
                (cand % max(self.burst_period_s, 1e-9)) < self.burst_len_s)
            local = np.where(in_burst, base * self.burst_mult, base)
            keep = rng.random(cand.size) * peak <= local
            return cand[keep]
        # diurnal: thin against the peak of rate_fn sampled on a 60 s grid
        grid = np.arange(0.0, horizon + 60.0, 60.0)
        rates = np.array([self.rate(float(g)) for g in grid])
        peak = float(rates.max()) * 1.05
        if peak <= 0:
            return np.empty(0, np.float64)
        cand = self._gap_times(rng, 1.0 / peak, horizon)
        local = np.array([self.rate(float(c)) for c in cand])
        keep = rng.random(cand.size) * peak <= local
        return cand[keep]

    @staticmethod
    def _gap_times(rng: np.random.Generator, mean_gap: float,
                   horizon: float) -> np.ndarray:
        size = max(int(_GAP_BATCH_FACTOR * horizon / mean_gap), 8)
        gaps = rng.exponential(mean_gap, size=size)
        times = np.cumsum(gaps)
        # top up in the (vanishingly rare, E[total] = 2×horizon) case the
        # batch falls short — the historical code would silently truncate
        while times.size and times[-1] < horizon:
            more = np.cumsum(rng.exponential(mean_gap, size=size))
            times = np.concatenate([times, times[-1] + more])
        return times[times < horizon]

    def first_n(self, n: int) -> np.ndarray:
        """The first ``n`` arrival timestamps.  For ``poisson`` this is one
        ``rng.exponential(mean_gap, n)`` cumulative sum — bit-for-bit the
        stream ``examples/serve_multiplex.py`` historically built ad hoc."""
        if self.kind == "poisson":
            return np.cumsum(_rng(self.seed).exponential(self.mean_gap, n))
        if self.kind == "trace-replay":
            if self._times.size < n:
                raise ValueError(
                    f"trace holds {self._times.size} arrivals, need {n}")
            return self._times[:n].copy()
        # inhomogeneous kinds: grow the horizon until n arrivals land
        horizon = n * self.mean_gap * 2 if self.mean_gap else n * 2.0
        for _ in range(20):
            ts = self.times(horizon)
            if ts.size >= n:
                return ts[:n]
            horizon *= 2
        raise ValueError(f"could not generate {n} arrivals (rate ~ 0?)")

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"ArrivalProcess(kind={self.kind!r}, seed={self.seed!r}, "
                f"mean_gap={self.mean_gap})")


def expected_count(process: ArrivalProcess, horizon: float,
                   dt: float = 60.0) -> float:
    """Trapezoid estimate of E[arrivals in [0, horizon)] — the rate-
    conservation contract ``times()``/``counts_at()`` are tested against."""
    grid = np.arange(0.0, horizon + dt, dt)
    rates = np.array([process.rate(float(g)) for g in grid])
    trapezoid = getattr(np, "trapezoid", np.trapz)   # numpy<2 fallback
    return float(trapezoid(rates, grid[:rates.size]))
