"""What the readers share: the loop's steps outside the traced stretch
(the profiler's cost lies inside it), and the device time of the
program's spans in the traced stretch (`muxbench/spans.py`'s join)."""
from __future__ import annotations


def untraced(rd, kind: str) -> list:
    return [s for s in rd.rec.spans if s.kind == kind and not s.traced]


def horizon(rd) -> float:
    """Seconds of the window before the traced stretch."""
    rec = rd.rec
    return rec.trace_from if rec.trace_from is not None else rec.seconds


def device_ms(rd, name: str) -> float | None:
    """Device ms a span `name` of the traced stretch, its children's
    operations included; None where the trace holds no device operation
    or the stretch no such span."""
    joined = getattr(rd, "spans", None)
    if not joined or not joined["ops"]:
        return None
    r = joined["names"].get(name)
    if not r or not r["count"]:
        return None
    return r["device_ms_all"] / r["count"]
