"""Model FLOPs of the offline train steps (forward and backward of every
projection, the top-k experts, attention; no recomputation counted;
the step's `work`, from the configuration's reference module) over their
wall time and the card's bf16 peak, outside the traced stretch."""
from muxbench.metrics._spans import untraced


def read(rd):
    spans = untraced(rd, "offline")
    t = sum(s.end - s.start for s in spans)
    if not spans or t <= 0:
        return None
    return 100.0 * sum(s.work["flops"] for s in spans) / t / rd.peak_flops
