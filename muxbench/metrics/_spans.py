"""What the host-clock readers share: the spans and requests outside the
traced stretch (the profiler's cost lies inside it)."""
from __future__ import annotations


def untraced(rd, kind: str) -> list:
    return [s for s in rd.rec.spans if s.kind == kind and not s.traced]


def horizon(rd) -> float:
    """Seconds of the window before the traced stretch."""
    rec = rd.rec
    return rec.trace_from if rec.trace_from is not None else rec.seconds
