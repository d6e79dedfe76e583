"""Share of the window's wall time spent in offline steps, before the
traced stretch (host clock): how much of the card the throttle gives the
offline job."""
from muxbench.metrics._spans import horizon, untraced


def read(rd):
    spans = untraced(rd, "offline")
    end = horizon(rd)
    if not spans or end <= 0:
        return None
    return 100.0 * sum(max(0.0, min(s.end, end) - s.start)
                       for s in spans) / end
