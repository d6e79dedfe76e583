"""MuxFlow's on-device unit on the wall clock: `Multiplexer.run`'s rule,
moved off its virtual clock.

In each turn of the loop:
  1. if any request is due and unserved, one online step serves up to
     `max_batch` of them, oldest first, and the throttle's PID is fed the
     step's slowdown over the decode time measured alone;
  2. otherwise, if the throttle grants a quantum, one offline step runs;
  3. otherwise the loop waits for the next due time, at most one quantum.
Every step ends in a synchronise, so its span is its work on the device.
At the window's close no step is begun; the requests due in the window
and still waiting are then served, and their latency counts the wait.
A traced stretch (`on_turn`) ends only once they are served.
`Multiplexer.run`'s eviction is not applied (there it ends the online
side too): the requests over the guard's budget are counted instead.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np


class WallClock:
    now = staticmethod(time.perf_counter)
    sleep = staticmethod(time.sleep)


@dataclasses.dataclass
class Span:
    kind: str            # "online" | "offline"
    start: float         # seconds from the window's start
    end: float
    requests: int = 0    # requests an online step served
    step: int = -1       # the side's step index
    traced: bool = False


@dataclasses.dataclass
class Record:
    seconds: float
    due: np.ndarray                  # each request's due time
    start: np.ndarray                # start of the step that served it
    end: np.ndarray                  # end of that step (nan: never)
    traced_req: np.ndarray           # served by or due in a traced stretch
    spans: list
    trace_from: float | None = None  # the traced stretch's start, if any
    t0: float = 0.0                  # the window's start on the clock

    @property
    def latency(self) -> np.ndarray:
        return self.end - self.due


def run_window(arrivals: np.ndarray, seconds: float, online, offline,
               throttle, *, max_batch: int, quantum: float, base_s: float,
               slo_slowdown: float, clock=WallClock, on_turn=None) -> Record:
    """Runs the loop for `seconds` from now.  online(rows) serves one step
    for `rows` requests and returns its step index; offline() runs one
    step and returns its index (None: no offline side).  on_turn(t), if
    given, is called before each turn with the window's time and returns
    True while that turn is traced, and with None once the requests due
    in the window are all served."""
    n = len(arrivals)
    start = np.full(n, np.nan)
    end = np.full(n, np.nan)
    traced_req = np.zeros(n, dtype=bool)
    spans: list[Span] = []
    queue: deque = deque()
    nxt = 0
    trace_from = None
    t0 = clock.now()

    def serve(t: float, traced: bool) -> None:
        batch = [queue.popleft() for _ in range(min(max_batch, len(queue)))]
        i = online(len(batch))
        t1 = clock.now() - t0
        start[batch], end[batch] = t, t1
        traced_req[batch] = traced
        spans.append(Span("online", t, t1, len(batch), i, traced))
        # telemetry -> PID, as `Multiplexer.run` feeds it
        throttle.pid.cfg.setpoint = slo_slowdown
        throttle.duty = throttle.pid.update((t1 - t) / max(base_s, 1e-9),
                                            t1 - t)

    while True:
        t = clock.now() - t0
        if t >= seconds:
            break
        traced = bool(on_turn(t)) if on_turn else False
        if traced and trace_from is None:
            trace_from = t
        while nxt < n and arrivals[nxt] <= t:
            queue.append(nxt)
            nxt += 1
        if queue:
            serve(t, traced)
        elif (offline is not None and not throttle.frozen
              and throttle.should_launch(quantum)):
            i = offline()
            spans.append(Span("offline", t, clock.now() - t0, 0, i, traced))
        else:
            due = arrivals[nxt] if nxt < n else seconds
            clock.sleep(min(max(due - t, 0.0), quantum))
    while nxt < n:                    # every request due in the window
        queue.append(nxt)
        nxt += 1
    while queue:
        serve(clock.now() - t0, trace_from is not None)
    if on_turn:
        on_turn(None)
    if trace_from is not None:
        traced_req |= arrivals >= trace_from
    return Record(seconds, np.asarray(arrivals, float), start, end,
                  traced_req, spans, trace_from, t0)


def offline_tokens(rec: Record, tokens_per_step: int) -> float:
    """Tokens of the offline steps done in the window: a step that the
    close cuts counts for its share inside the window."""
    done = 0.0
    for s in rec.spans:
        if s.kind != "offline" or s.start >= rec.seconds:
            continue
        inside = min(s.end, rec.seconds) - s.start
        done += tokens_per_step * inside / max(s.end - s.start, 1e-12)
    return done


def guard_budget_s(mux_cfg, base_s: float) -> float:
    """The SLO guard's budget, as `Multiplexer.run` sets it."""
    return mux_cfg.latency_budget_s or mux_cfg.slo_slowdown * base_s * 4
