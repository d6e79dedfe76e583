"""Graceful exit (§4.2): SIGINT/SIGTERM interception for the offline side
of the multiplexer, copied from `repro/core/errors.py` with the same
behaviour, with the error kinds it records."""
from __future__ import annotations

import contextlib
import enum
import signal


class ErrorKind(enum.Enum):
    SIGINT = "sigint"
    SIGTERM = "sigterm"
    MPS_SERVER_CRASH = "mps_server_crash"
    XID31_PAGE_FAULT = "xid31_page_fault"
    MPS_HANG = "mps_hang"


class GracefulExit:
    """Real SIGINT/SIGTERM interception for the offline process: on signal,
    freeze kernel launches (via the throttle), run the checkpoint callback,
    release resources, then exit cleanly.  Usable as a context manager.
    """

    def __init__(self, throttle=None, on_checkpoint=None, on_release=None):
        self.throttle = throttle
        self.on_checkpoint = on_checkpoint
        self.on_release = on_release
        self.triggered: ErrorKind | None = None
        self._prev: dict[int, object] = {}

    def _handler(self, signum, frame):
        self.triggered = (ErrorKind.SIGINT if signum == signal.SIGINT
                          else ErrorKind.SIGTERM)
        if self.throttle is not None:
            self.throttle.freeze()            # freeze all kernel launches
        if self.on_checkpoint is not None:
            self.on_checkpoint()              # persist offline progress
        if self.on_release is not None:
            self.on_release()                 # release the CUDA context

    def __enter__(self):
        for sig in (signal.SIGINT, signal.SIGTERM):
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            with contextlib.suppress(Exception):
                signal.signal(sig, prev)
        return False
