"""Share of the online steps before the traced stretch that the decode
step replayed from a CUDA graph (its `replays` counter over the loop's
online steps); the rest ran eagerly."""
from muxbench.metrics._spans import untraced


def read(rd):
    c = getattr(rd, "counters", None)
    steps = len(untraced(rd, "online"))
    if not c or "replays" not in c["before"] or not steps:
        return None
    return 100.0 * c["before"]["replays"] / steps
