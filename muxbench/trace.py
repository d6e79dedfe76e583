"""The traced run's device trace: torch.profiler over the last seconds of
the window, read in memory (nothing is written to disk).

The profiler records the device's activity alone (its kernels, copies and
the runtime calls that launched them), not the host's operators: recording
every operator of a host-bound decode step slowed each online step enough
that they chained and starved the offline side, so that the traced stretch
no longer stood for the window.  The method is the port's
`launch/profile.py`'s (device time by kernel from the profiler), copied
here and taken over the traced stretch as a whole: the busy time is the
union of every device operation's interval, the stretch runs from the
first to the last event the profiler recorded, and each idle gap between
device operations is put down to what the host was doing at its middle:
the loop's step there (`mux.online`, `mux.offline`, or `mux.loop` between
steps), from the loop's own record on the host clock, and the runtime call
the profiler recorded there.

Where the job ran no step in the stretch, the stretch ends at the
window's close and the profiler stays on for one step of the job after
it (`end_stretch`): that step is joined to the spans, and is no part of
the summary.

Over the same stretch the tracer attaches the program's span log
(`repro_torch.obs.spans`); once stopped, `spans` holds its spans as
(name, start ns, end ns or None, parent) on the profiler's clock and
`dropped` the spans past the log's cap, for `muxbench/spans.py`'s join.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

TOP = 10


class Tracer:
    def __init__(self, cuda: bool):
        import torch
        self.torch = torch
        act = torch.profiler.ProfilerActivity
        self.acts = [act.CUDA] if cuda else [act.CPU]
        self.device = "cuda" if cuda else "cpu"
        self.prof = None
        self.active = False
        self.events = []
        self.spans = []
        self.dropped = 0
        self.offset_ns = 0
        self.end_ns = None    # the stretch's end, where a step follows it

    def warm_up(self) -> None:
        """One short profile in set-up, so that the profiler's own start
        (CUPTI's) is not inside the window."""
        torch = self.torch
        with torch.profiler.profile(activities=self.acts):
            torch.ones(8, device=self.device).sum()

    def start(self) -> None:
        from repro_torch.obs import spans
        self.prof = self.torch.profiler.profile(activities=self.acts)
        self.prof.start()
        self.active = True
        # the profiler's clock is the system's real-time clock, in ns
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        spans.attach()

    def end_stretch(self) -> None:
        """Ends the traced stretch while the profiler stays on: what is
        recorded from now is joined to the program's spans and left out of
        `summary`."""
        self.end_ns = time.perf_counter_ns() + self.offset_ns

    def stop(self) -> None:
        if not self.active:
            return
        from repro_torch.obs import spans
        log = spans.detach()
        self.prof.stop()
        self.active = False
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None
        off = self.offset_ns
        self.spans = [(s.name, s.start_ns + off,
                       None if s.end_ns is None else s.end_ns + off, s.parent)
                      for s in log.spans()]
        self.dropped = log.dropped

    def summary(self, rec) -> dict:
        """The trace's reading, with the loop's record `rec` (its steps on
        the host clock) naming the idle gaps."""
        steps = [(int((rec.t0 + s.start) * 1e9) + self.offset_ns,
                  int((rec.t0 + s.end) * 1e9) + self.offset_ns,
                  f"mux.{s.kind}") for s in rec.spans]
        events = self.events if self.end_ns is None else \
            [e for e in self.events if e.start_ns() < self.end_ns]
        return summarize(events, steps)


def union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, steps: list) -> dict:
    """busy_s, window_s, device seconds by kernel name, the busy seconds
    by the loop's step they fell in, and the idle seconds by host
    activity, from the profiler's events and the loop's steps ((start ns,
    end ns, name) on the profiler's clock)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        item = (e.start_ns(), e.end_ns(), e.name())
        (host if e.device_type() == DeviceType.CPU else dev).append(item)
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {},
                "busy_by_step": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    t0 = min(a for a, _, _ in dev + host)
    t1 = max(b for _, b, _ in dev + host)
    busy = union([[a, b] for a, b, _ in dev])
    kernels = defaultdict(float)
    for a, b, name in dev:
        kernels[short(name)] += (b - a) / 1e9
    steps = sorted(steps)
    ops = sorted(host)
    by_step = defaultdict(float)
    for a, b in busy:
        by_step[covering((a + b) / 2, steps) or "mux.loop"] += (b - a) / 1e9
    idle = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            step = covering(mid, steps) or "mux.loop"
            idle[f"{step}/{short(covering(mid, ops) or '-', 80)}"] += \
                (b - a) / 1e9
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": (t1 - t0) / 1e9, "kernels": dict(kernels),
            "busy_by_step": dict(by_step),
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                          "idle_gaps": [[n, s] for n, s in top_idle]}}


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its argument list, at most `width`
    characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i:
            cut = i
            break
    return name[:cut][:width]


def covering(t: float, events: list, limit: int = 4096) -> str | None:
    """The latest-starting event of `events` (sorted by start) that covers
    t: the innermost, for nested events."""
    i = bisect.bisect_right(events, (t, float("inf"), ""))
    for a, b, name in reversed(events[max(0, i - limit):i]):
        if b >= t:
            return name
    return None
