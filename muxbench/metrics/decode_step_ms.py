"""Mean wall time of an online step, each ending in a synchronise, over
the steps outside the traced stretch (host clock)."""
from muxbench.metrics._spans import untraced


def read(rd):
    spans = untraced(rd, "online")
    if not spans:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / len(spans)
