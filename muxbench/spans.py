"""The program's spans joined to the device trace of a traced stretch.

The program records spans on the host (`repro_torch.obs.spans`: name,
start, end and parent, from `time.perf_counter_ns`); moved onto the
profiler's clock with the offset that `trace.Tracer.start` takes, they
are joined here to the profiler's events of the same stretch.  Each
device operation (kernel, copy, set) goes to the innermost span that
contains the start of the runtime call that launched it, found by the
profiler's correlation id.  Attribution goes by time and not by thread:
the autograd engine launches the backward's kernels from its own thread
while the main thread waits inside `train.backward`, and the loop's
online and offline steps never overlap in time.  A trace without device
operations (a run on the CPU, or a stretch whose device activity the
profiler lost) gives the spans' counts and host times and no device
reading.

Per span name the join gives the count, the host time and the host self
time (the span's time less its child spans'), and the device time and the
number of the operations attributed to the span, alone and with its
children's; and as a check of the clocks, the share of `decode_partial`
operations whose runtime call lies where it must: inside a
`decode.attention` span for a kernel launched on its own, inside a
`decode.replay` span for one that a replayed CUDA graph ran (its runtime
call is the graph's one `cudaGraphLaunch`).

`trace.Tracer` attaches the program's log over the traced stretch and
moves its spans onto the profiler's clock; `bench.run` hands `join`'s
reading to the metric readers and prints `line`.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

CHECK_KERNEL, CHECK_SPAN = "decode_partial", "decode.attention"
GRAPH_CALL, GRAPH_SPAN = "cudaGraphLaunch", "decode.replay"
FIELDS = ("count", "host_ms", "self_host_ms", "device_ms", "device_ms_all",
          "launches", "launches_all")


def innermost(spans: list) -> tuple[list, list]:
    """The innermost span open at each time, as (starts, owners): from
    starts[k] to starts[k + 1] the innermost open span is owners[k], an
    index into `spans` ((name, start, end, parent), end None for a span
    left open), -1 where none is open.  The innermost is the latest to
    start, and of two that start together the later opened."""
    bounds = []
    for i, (_, a, b, _) in enumerate(spans):
        if b is not None:
            bounds += [(a, 1, i), (b, 0, i)]
    bounds.sort()
    active: dict = {}
    starts, owners = [], []
    for t, opens, i in bounds:
        if opens:
            active[i] = spans[i][1]
        else:
            active.pop(i, None)
        own = max(active, key=lambda j: (active[j], j)) if active else -1
        if starts and starts[-1] == t:
            owners[-1] = own
        else:
            starts.append(t)
            owners.append(own)
    return starts, owners


def owner_at(t: float, timeline: tuple) -> int:
    """The innermost span open at time t (-1: none)."""
    starts, owners = timeline
    k = bisect.bisect_right(starts, t) - 1
    return owners[k] if k >= 0 else -1


def device_ops(events) -> list:
    """(launch ns or None, start ns, end ns, name, runtime call) of each
    device operation, its launch the start of the runtime call of the
    same correlation id and its runtime call that call's name."""
    from torch.autograd import DeviceType
    calls, dev = {}, []
    for e in events:
        cid = e.correlation_id()
        if e.device_type() == DeviceType.CPU:
            if cid:
                calls.setdefault(cid, (e.start_ns(), e.name()))
        else:
            dev.append((cid, e.start_ns(), e.end_ns(), e.name()))
    out = []
    for cid, a, b, name in dev:
        launch, call = calls.get(cid, (None, None)) if cid else (None, None)
        out.append((launch, a, b, name, call))
    return out


def join(events, spans: list) -> dict | None:
    """The reading of the profiler's `events` against the program's
    `spans` ((name, start ns, end ns or None, parent) on the profiler's
    clock): per span name the FIELDS, summed over its spans (times in ms),
    the clock check, and how many operations went to no span.  None
    without spans."""
    if not spans:
        return None
    n = len(spans)
    timeline = innermost(spans)
    ops = device_ops(events)
    self_ns, self_ops = [0] * n, [0] * n
    unlinked = outside = checked = inside = 0
    for launch, a, b, name, call in ops:
        if launch is None:
            unlinked += 1
            continue
        i = owner_at(launch, timeline)
        if CHECK_KERNEL in name:
            checked += 1
            inside += (GRAPH_SPAN if call == GRAPH_CALL else CHECK_SPAN) \
                in ancestry(spans, i)
        if i < 0:
            outside += 1
            continue
        self_ns[i] += b - a
        self_ops[i] += 1
    all_ns, all_ops = self_ns[:], self_ops[:]
    child_ns = [0] * n
    # a parent opened before its children: its index is the smaller
    for i in reversed(range(n)):
        name, a, b, parent = spans[i]
        if parent >= 0 and b is not None:
            all_ns[parent] += all_ns[i]
            all_ops[parent] += all_ops[i]
            child_ns[parent] += b - a
    names: dict = defaultdict(lambda: dict.fromkeys(FIELDS, 0))
    for i, (name, a, b, _) in enumerate(spans):
        if b is None:
            continue
        r = names[name]
        r["count"] += 1
        r["host_ms"] += (b - a) / 1e6
        r["self_host_ms"] += (b - a - child_ns[i]) / 1e6
        r["device_ms"] += self_ns[i] / 1e6
        r["device_ms_all"] += all_ns[i] / 1e6
        r["launches"] += self_ops[i]
        r["launches_all"] += all_ops[i]
    return {"names": dict(names), "ops": len(ops), "unlinked": unlinked,
            "outside": outside,
            "clock_check": inside / checked if checked else None}


def ancestry(spans: list, i: int) -> list:
    """The names of span i and of its ancestors, innermost first."""
    out = []
    while i >= 0:
        out.append(spans[i][0])
        i = spans[i][3]
    return out


def line(reading: dict | None, dropped: int = 0) -> str:
    """The `[spans]` line of standard error: each name's count and its
    means a span, the clock check, and the operations that went to no
    span."""
    if not reading:
        return "[spans] none: the program recorded no span"
    parts = []
    for name, r in sorted(reading["names"].items()):
        c = r["count"]
        parts.append(
            f"{name}:n={c},host_ms={r['host_ms'] / c:.4f},"
            f"self_host_ms={r['self_host_ms'] / c:.4f},"
            f"device_ms={r['device_ms'] / c:.4f},"
            f"device_ms_all={r['device_ms_all'] / c:.4f},"
            f"launches={r['launches'] / c:.2f},"
            f"launches_all={r['launches_all'] / c:.2f}")
    return (f"[spans] clock_check={reading['clock_check']} "
            f"ops={reading['ops']} unlinked={reading['unlinked']} "
            f"outside={reading['outside']} dropped={dropped} "
            + " ".join(parts))
