"""Opt-in wall-clock profiling of the engine tick's phases.

Attached to a :class:`ClusterSim` via ``attach_phases``, the profiler
accumulates wall time per phase of the tick pipeline::

    inputs      _tick_inputs (RNG draws, profile arrays, policy surfaces)
    predict     build_weight_grid_arrays (speed-predictor weight grid)
    match       solve_matching (Kuhn-Munkres / incremental shards)
    dense_core  the numpy tick core or the torch engine's call (on the
                card, its time includes the copy back of the block's
                outputs, so no synchronize is needed)
    account     the engine-agnostic epilogue (minus the serving slice)
    serving     the serving plane's lane stepping inside _account

QUARANTINED: these numbers are wall clock and therefore never enter any
deterministic artifact — they surface only in ``BENCH_sim.json`` (the
``obs_overhead`` suite) and on stderr (``--profile-phases``).  The report's
``obs`` section records *that* profiling ran, never its timings.

Copied from `repro/obs/phases.py` with the same behaviour.
"""
from __future__ import annotations

import contextlib
import time

PHASES = ("inputs", "predict", "match", "dense_core", "account", "serving")


class PhaseProfiler:
    """Accumulates ``(wall_s, calls)`` per named phase."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.totals: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, exclude: tuple = ()):
        """Time a block under ``name``.  ``exclude`` subtracts the growth of
        other phases timed *inside* the block (e.g. ``account`` excludes the
        nested ``serving`` slice so the two don't double-count)."""
        t0 = self.clock()
        pre = [self.totals.get(x, 0.0) for x in exclude]
        try:
            yield
        finally:
            dt = self.clock() - t0
            for x, p in zip(exclude, pre):
                dt -= self.totals.get(x, 0.0) - p
            self.add(name, dt)

    def add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def summary(self) -> dict:
        """Wall-clock phase table (for BENCH_sim.json / stderr ONLY)."""
        return {"phases": {n: {"wall_s": round(self.totals[n], 6),
                               "calls": self.calls[n]}
                           for n in sorted(self.totals)},
                "total_s": round(sum(self.totals.values()), 6)}

    def format_table(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"[phases] {'phase':12s} {'wall_s':>10s} {'share':>7s} "
                 f"{'calls':>9s}"]
        order = [p for p in PHASES if p in self.totals]
        order += [p for p in sorted(self.totals) if p not in PHASES]
        for n in order:
            w = self.totals[n]
            lines.append(f"[phases] {n:12s} {w:10.3f} {w / total:7.1%} "
                         f"{self.calls[n]:9d}")
        lines.append(f"[phases] {'total':12s} {total:10.3f}")
        return "\n".join(lines)
