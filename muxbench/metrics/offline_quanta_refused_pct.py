"""Share of the quanta the offline side asked the throttle for that it
refused (`KernelThrottle`'s `refused` over `granted` plus `refused`), in
the window before the traced stretch."""


def read(rd):
    c = getattr(rd, "counters", None)
    if not c:
        return None
    before = c["before"]
    asked = before["granted"] + before["refused"]
    if not asked:
        return None
    return 100.0 * before["refused"] / asked
