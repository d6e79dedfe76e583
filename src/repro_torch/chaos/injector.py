"""The `FaultInjector` protocol — the seam every chaos-aware module consults.

Chaos is injected through *explicit seams*, never monkey-patching: each
subsystem that can fail holds an optional ``fault_injector`` attribute
(default ``None``) and consults it at well-defined points.  When the
attribute is ``None`` — every non-chaos run — the consult is skipped
entirely and the trajectory stays byte-identical to a build without the
chaos plane.  When set, the injector decides *whether* a fault fires and
the module's graceful-degradation ladder decides *how* to survive it.

Seams (consulted by → method):

==============================  =======================================
``cluster.agents``              ``agent_outage(t)``, ``heartbeat_skew(t)``
``durability.store``            ``store_fault(op)``, ``note_io_recovered``
``core.simulator._schedule``    ``predictor_down(t)``,
                                ``note_predictor_fallback(t)``,
                                ``matcher_exhausted(t)``,
                                ``note_matcher_fallback(t, free, jobs)``
``serving_plane.plane``         ``serving_burst_mult(t)``,
                                ``brownout_frac(t)``
==============================  =======================================

:class:`FaultInjector` is the no-op base (usable directly as a "chaos
plane that never fires"); :class:`repro_torch.chaos.campaign.ChaosCampaign` is
the seeded production implementation; :class:`ScriptedInjector` is a
deterministic hand-scripted stub for unit-testing individual seams.

Copied from `repro/chaos/injector.py` with the same behaviour.
"""
from __future__ import annotations

import numpy as np


class FaultInjector:
    """No-op injector: every method returns "no fault".

    Subclasses override only the seams they perturb.  Return conventions
    are chosen so the neutral value short-circuits cheaply: ``None`` means
    "don't even build the mask", ``False``/``1.0``/``0.0`` mean "no
    fault this consult".
    """

    # ---- cluster.agents -------------------------------------------------
    def agent_outage(self, t: float):
        """Bool mask over devices whose node agent is crashed at ``t``
        (crashed agents miss their heartbeat), or ``None`` for no outages."""
        return None

    def heartbeat_skew(self, t: float):
        """Per-device clock skew (seconds) subtracted from heartbeat
        timestamps at ``t``, or ``None`` for no skew."""
        return None

    # ---- durability.store -----------------------------------------------
    def store_fault(self, op: str) -> bool:
        """True to fail this IO attempt (``op`` in append/flush/fsync).
        Consulted *before* the real operation, so an injected fault never
        leaves a partial write behind."""
        return False

    def note_io_recovered(self, op: str, attempts: int) -> None:
        """The store's bounded retry ladder absorbed a transient fault."""

    # ---- core.simulator scheduling round --------------------------------
    def predictor_down(self, t: float) -> bool:
        """True while the trained speed predictor is unavailable."""
        return False

    def note_predictor_fallback(self, t: float) -> None:
        """A scheduling round ran on the static share table instead."""

    def matcher_exhausted(self, t: float) -> bool:
        """True when the KM matching time budget is exhausted this round."""
        return False

    def note_matcher_fallback(self, t: float, n_free: int,
                              n_jobs: int) -> None:
        """A scheduling round fell back to greedy-FIFO placement."""

    # ---- serving_plane --------------------------------------------------
    def serving_burst_mult(self, t: float) -> float:
        """Demand multiplier applied to lane arrivals at ``t`` (1.0 = none).
        Applied *after* the arrival draw so the RNG stream is untouched."""
        return 1.0

    def brownout_frac(self, t: float) -> float:
        """Fraction of the queue to brownout-shed at ``t`` (0.0 = none)."""
        return 0.0


class ScriptedInjector(FaultInjector):
    """Hand-scripted injector for unit tests — no RNG, no episodes.

    Attributes are plain knobs the test sets; calls are recorded so the
    test can assert the ladder engaged (``recovered``, ``pred_rounds``,
    ``matcher_rounds``).
    """

    def __init__(self, *, store_faults: int = 0,
                 predictor_down: bool = False,
                 matcher_exhausted: bool = False,
                 burst_mult: float = 1.0, brownout: float = 0.0,
                 down_mask=None, skew_s: float = 0.0):
        self.store_faults = int(store_faults)   # remaining IO faults to fire
        self._pred_down = bool(predictor_down)
        self._matcher = bool(matcher_exhausted)
        self.burst_mult = float(burst_mult)
        self.brownout = float(brownout)
        self.down_mask = (None if down_mask is None
                          else np.asarray(down_mask, dtype=bool))
        self.skew_s = float(skew_s)
        self.recovered: list[tuple[str, int]] = []
        self.pred_rounds = 0
        self.matcher_rounds = 0

    def agent_outage(self, t):
        return self.down_mask

    def heartbeat_skew(self, t):
        return self.skew_s if self.skew_s else None

    def store_fault(self, op):
        if self.store_faults > 0:
            self.store_faults -= 1
            return True
        return False

    def note_io_recovered(self, op, attempts):
        self.recovered.append((op, int(attempts)))

    def predictor_down(self, t):
        return self._pred_down

    def note_predictor_fallback(self, t):
        self.pred_rounds += 1

    def matcher_exhausted(self, t):
        return self._matcher

    def note_matcher_fallback(self, t, n_free, n_jobs):
        self.matcher_rounds += 1

    def serving_burst_mult(self, t):
        return self.burst_mult

    def brownout_frac(self, t):
        return self.brownout
