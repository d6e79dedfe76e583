"""Opt-in wall-clock spans of the serve and train steps, kept in memory.

`span(name)` marks a block of the program::

    with span("decode.layer"):
        ...

While no log is attached (the default) it returns one shared no-op object
after a single check of a module global: no clock is read and no span
object is made.  `attach()` starts a log and `detach()` stops it and
returns it.  While attached, each span records its name, its start and
end from `time.perf_counter_ns()`, the index of its parent (the innermost
span open on the same thread, -1 at the top), into a list made when the
log is attached, up to `CAP` spans; the spans past the cap are counted as
`dropped`.

A span touches no tensor, never synchronises and never calls into CUDA:
its times are the host's, the launches of the block and not the device's
work.  Joining them to the device's (by a profiler's correlation ids) is
the reader's business.

The spans of the port:

  decode.step       `models/steps.make_decode_step`'s step
  decode.replay     the step's replay of a CUDA graph
                    (`models/decode_graph.DecodeStep`)
  decode.capture    the capture of one of the step's CUDA graphs
  decode.prepare    the step's positions, lengths and rotary angles
                    (`models/model._attn_step`; eagerly, after the one
                    host-to-device copy)
  decode.layer      one layer of the decode step
  decode.attention  `kernels/ops.decode_attention`'s kernel call
  decode.head       the final norm and the `lm_head` product
  train.step        `models/steps.make_train_step`'s step
  train.forward     the loss's forward
  train.backward    `torch.autograd.grad` of the loss
  train.optimizer   `optimizer.update` (clipping and the update)

A step replayed from a CUDA graph runs no Python inside it: its
`decode.prepare`, `decode.layer`, `decode.attention` and `decode.head` are
recorded when the graph is captured (under `decode.capture`) and not at
its replays, which record `decode.step` and `decode.replay` alone.

QUARANTINED like `phases.PhaseProfiler`: these numbers are wall clock and
never enter a deterministic artifact.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple

CAP = 1 << 16                # spans a log records


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None       # None: still open when the log was detached
    parent: int              # index of the enclosing span, -1 at the top


class SpanLog:
    """The spans recorded while attached, in the order they opened."""

    def __init__(self):
        self.cap = CAP
        self.opened = 0                     # spans opened, dropped included
        self._records: list = [None] * CAP
        self._lock = threading.Lock()
        self._local = threading.local()

    @property
    def dropped(self) -> int:
        """Spans opened past the cap, and not recorded."""
        return max(0, self.opened - self.cap)

    def spans(self) -> list[Span]:
        return [Span(*r) for r in self._records[:min(self.opened, self.cap)]]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Open:
    """One span of an attached log."""
    __slots__ = ("log", "name", "i")

    def __init__(self, log: SpanLog, name: str):
        self.log, self.name = log, name

    def __enter__(self):
        log = self.log
        with log._lock:
            i = log.opened
            log.opened = i + 1
        self.i = i
        if i < log.cap:
            stack = log._stack()
            log._records[i] = [self.name, time.perf_counter_ns(), None,
                               stack[-1] if stack else -1]
            stack.append(i)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        log = self.log
        if self.i < log.cap:
            log._records[self.i][2] = time.perf_counter_ns()
            log._stack().pop()
        return False


class _Off:
    """The shared span of a detached log: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_OFF = _Off()
_log: SpanLog | None = None


def span(name: str):
    """A context manager marking one block under `name` (see the module's
    docstring)."""
    if _log is None:
        return _OFF
    return _Open(_log, name)


def attach() -> SpanLog:
    """Starts recording spans into a new log of at most `CAP` spans, in
    place of any log attached before; returns it."""
    global _log
    _log = SpanLog()
    return _log


def detach() -> SpanLog | None:
    """Stops recording; returns the log that was attached (None if none
    was)."""
    global _log
    log, _log = _log, None
    return log
