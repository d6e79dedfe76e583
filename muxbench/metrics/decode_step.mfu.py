"""Model FLOPs of the online steps (every projection at the served batch,
attention over the keys each row sees; the step's `work`, from the
configuration's reference module) over their wall time and the card's
bf16 peak, outside the traced stretch."""
from muxbench.metrics._spans import untraced


def read(rd):
    spans = untraced(rd, "online")
    t = sum(s.end - s.start for s in spans)
    if not spans or t <= 0:
        return None
    return 100.0 * sum(s.work["flops"] for s in spans) / t / rd.peak_flops
