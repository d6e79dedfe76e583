"""Mixed error handling (§4.2) — safety protection for online workloads,
copied from `repro/core/errors.py` with the same behaviour.

The paper's production error census (Fig. 7): ~99 % of propagated errors are
SIGINT/SIGTERM container stops; the rest are MPS server crashes, XID31 memory
page faults, and other MPS hangs.  MuxFlow therefore:

  * intercepts SIGINT/SIGTERM in the offline container, freezes kernel
    launches, and releases the CUDA context actively (graceful exit);
  * for the 1 % tail, matches error patterns with an automated detector and
    resets the context + MPS server.

`GracefulExit` is a real signal-handling harness (used by the multiplexer and
the launchers); `MixedErrorHandler` encodes the policy; the simulator injects
this taxonomy to measure propagation with/without the mechanism.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import signal


class ErrorKind(enum.Enum):
    SIGINT = "sigint"
    SIGTERM = "sigterm"
    MPS_SERVER_CRASH = "mps_server_crash"
    XID31_PAGE_FAULT = "xid31_page_fault"
    MPS_HANG = "mps_hang"



# Production proportions (Fig. 7): SIGINT+SIGTERM = 99 %.
ERROR_MIX: dict[ErrorKind, float] = {
    ErrorKind.SIGINT: 0.62,
    ErrorKind.SIGTERM: 0.37,
    ErrorKind.MPS_SERVER_CRASH: 0.004,
    ErrorKind.XID31_PAGE_FAULT: 0.003,
    ErrorKind.MPS_HANG: 0.003,
}


class Action(enum.Enum):
    GRACEFUL_EXIT = "graceful_exit"        # freeze launches + release context
    RESET_CONTEXT = "reset_context"        # reset CUDA context + MPS server


@dataclasses.dataclass
class HandledError:
    kind: ErrorKind
    action: Action
    propagated: bool          # did the shared online workload feel it?


class MixedErrorHandler:
    """Policy: signals → graceful exit (never propagates); pattern-matched
    tail errors → detector alert → context/MPS reset (brief online impact,
    matching the deployment's residual 0.9 % vs 0.7 % device error rate)."""

    SIGNAL_KINDS = (ErrorKind.SIGINT, ErrorKind.SIGTERM)

    def __init__(self, graceful_enabled: bool = True,
                 detector_enabled: bool = True):
        self.graceful_enabled = graceful_enabled
        self.detector_enabled = detector_enabled
        self.handled: list[HandledError] = []

    def handle(self, kind: ErrorKind) -> HandledError:
        if kind in self.SIGNAL_KINDS:
            if self.graceful_enabled:
                h = HandledError(kind, Action.GRACEFUL_EXIT, propagated=False)
            else:  # the un-protected baseline: MPS context hangs, online dies
                h = HandledError(kind, Action.RESET_CONTEXT, propagated=True)
        else:
            # tail errors: detector alerts, context reset; propagation only
            # if the detector is off (no automated pattern matching)
            h = HandledError(kind, Action.RESET_CONTEXT,
                             propagated=not self.detector_enabled)
        self.handled.append(h)
        return h

    def propagation_rate(self) -> float:
        if not self.handled:
            return 0.0
        return sum(1 for h in self.handled if h.propagated) / len(self.handled)


def error_from_uniform(u: float) -> ErrorKind:
    """Map a uniform [0,1) draw to an error kind per the production mix.
    Split out from :func:`sample_error` so the simulator engines can consume
    pre-drawn per-tick uniform vectors (keeps both engines on one RNG
    stream)."""
    kinds = list(ERROR_MIX)
    probs = [ERROR_MIX[k] for k in kinds]
    total = sum(probs)
    r = u * total
    acc = 0.0
    for k, p in zip(kinds, probs):
        acc += p
        if r <= acc:
            return k
    return kinds[-1]


def sample_error(rng) -> ErrorKind:
    return error_from_uniform(rng.random())

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
