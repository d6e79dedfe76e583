"""Typed control-plane events and a deterministic event bus.

Every discrete thing that happens in a scenario — a job placement, an
eviction, an injected fault, an agent going stale, an autoscaler decision —
flows through one :class:`EventBus` as an :class:`Event`.  The bus is
single-threaded and assigns a monotonically increasing sequence number at
emission, so under a fixed seed the full event stream is bit-reproducible;
``digest()`` hashes the canonical stream for replay/equality checks without
retaining every event object (at 20 000 devices a 12-hour campaign emits
hundreds of thousands of events).

Copied from `repro/cluster/events.py` with the same behaviour.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Callable


class EventKind(str, enum.Enum):
    JOB_SUBMIT = "job_submit"
    JOB_START = "job_start"
    JOB_FINISH = "job_finish"
    JOB_EVICT = "job_evict"
    ERROR = "error"
    DEVICE_FAIL = "device_fail"
    SCHEDULE = "schedule"
    AGENT_STALE = "agent_stale"
    AGENT_FRESH = "agent_fresh"
    AUTOSCALE = "autoscale"
    # chaos plane: an injected infrastructure fault and the typed
    # degradation/recovery that answered it (data carries ("fault", kind)
    # and, for RECOVERY, ("action", ladder_rung))
    CHAOS_INJECT = "chaos_inject"
    RECOVERY = "recovery"


@dataclasses.dataclass(frozen=True)
class Event:
    seq: int
    t: float
    kind: EventKind
    device: int = -1          # -1: not device-scoped
    job: int = -1             # -1: not job-scoped
    data: tuple = ()          # small (key, value) pairs, hashable

    def key(self) -> tuple:
        """Canonical tuple — what the digest and determinism tests hash."""
        return (self.seq, round(self.t, 6), self.kind.value, self.device,
                self.job, self.data)


class EventBus:
    """Deterministic pub/sub: subscribers run synchronously in subscription
    order at ``emit`` time.  Keeps per-kind counts and a running SHA-256
    digest always; retains the raw event list only when ``keep_log`` is set
    (tests / small scenarios)."""

    def __init__(self, keep_log: bool = False, log_cap: int = 1_000_000):
        self._subs: dict[EventKind | None, list[Callable[[Event], None]]] = {}
        self.keep_log = keep_log
        self.log_cap = log_cap
        self.log: list[Event] = []
        self.dropped = 0                      # events not retained in `log`
        self.counts: dict[str, int] = {}
        self._seq = 0
        self._hash = hashlib.sha256()
        self._sinks: list[Callable[[Event], None]] = []
        self.sink_events = 0                  # events delivered to sinks
        self.sink_dropped = 0                 # contractually always 0

    def subscribe(self, fn: Callable[[Event], None],
                  kind: EventKind | None = None) -> None:
        """Subscribe to one kind, or to everything with ``kind=None``."""
        self._subs.setdefault(kind, []).append(fn)

    def attach_sink(self, fn: Callable[[Event], None]) -> None:
        """Attach a durable sink: called for EVERY event, before any
        subscriber, with no cap and no drop path (unlike ``keep_log``,
        which silently stops retaining past ``log_cap``).  A sink that
        raises aborts the emit — a write-ahead log must not fall behind
        the state it protects."""
        self._sinks.append(fn)

    def emit(self, t: float, kind: EventKind, device: int = -1,
             job: int = -1, data: tuple = ()) -> Event:
        ev = Event(self._seq, t, kind, device, job, data)
        self._seq += 1
        self.counts[kind.value] = self.counts.get(kind.value, 0) + 1
        self._hash.update(repr(ev.key()).encode())
        for fn in self._sinks:
            fn(ev)
            self.sink_events += 1
        if self.keep_log:
            if len(self.log) < self.log_cap:
                self.log.append(ev)
            else:
                self.dropped += 1
        for fn in self._subs.get(kind, ()):
            fn(ev)
        for fn in self._subs.get(None, ()):
            fn(ev)
        return ev

    @property
    def n_events(self) -> int:
        return self._seq

    def digest(self) -> str:
        """SHA-256 over the canonical event stream so far."""
        return self._hash.hexdigest()

    def summary(self) -> dict:
        """Counts + digest, plus backpressure counters: ``log_dropped`` is
        how many events the capped ``log`` silently omitted, while
        ``sink_events``/``sink_dropped`` account for the durable-sink seam
        (``sink_dropped`` is structurally zero — sinks run before any
        capping and have no drop path).  ``digest``/``counts`` always
        cover the full stream — only retention truncates."""
        return {"n_events": self._seq, "counts": dict(sorted(
            self.counts.items())), "digest": self.digest(),
            "log_dropped": self.dropped, "sink_events": self.sink_events,
            "sink_dropped": self.sink_dropped}
