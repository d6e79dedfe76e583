"""Mean time a request waits from its due time to the start of the online
step that serves it, over the requests outside the traced stretch (host
clock): the multiplexer loop and throttle's share of the online tail."""
import numpy as np


def read(rd):
    rec = rd.rec
    keep = ~rec.traced_req & ~np.isnan(rec.start)
    if not keep.any():
        return None
    return float(np.mean(rec.start[keep] - rec.due[keep]) * 1e3)
