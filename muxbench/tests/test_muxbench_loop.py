"""The loop's rule on a fake clock: online first, offline when the
throttle grants a quantum, no wait beyond a quantum, and every request due
in the window answered after its close, its wait counted."""
import numpy as np
from pytest import approx

from muxbench import loop, trace


class FakeClock:
    def __init__(self):
        self.t = 100.0
        self.sleeps = []

    def now(self):
        return self.t

    def sleep(self, dt):
        self.sleeps.append(dt)
        self.t += dt


class Throttle:
    """Grants every quantum; records what the PID is fed."""
    frozen = False

    def __init__(self, grant=True):
        self.grant = grant
        self.fed = []

        class Pid:
            class cfg:
                setpoint = 0.0

            def update(pid, slowdown, dt):
                self.fed.append(slowdown)
                return 0.9
        self.pid = Pid()
        self.duty = 0.5

    def should_launch(self, quantum):
        return self.grant


def make(clock, online_s=0.01, offline_s=0.3):
    log = []

    def online(rows):
        log.append(("on", clock.t, rows))
        clock.t += online_s
        return len(log)

    def offline():
        log.append(("off", clock.t))
        clock.t += offline_s
        return len(log)
    return log, online, offline


def run(arr, seconds, clock, thr, online, offline):
    return loop.run_window(np.array(arr), seconds, online, offline, thr,
                           max_batch=8, quantum=0.01, base_s=0.01,
                           slo_slowdown=1.25, clock=clock)


def test_online_first_then_offline():
    clock, thr = FakeClock(), Throttle()
    log, on, off = make(clock)
    rec = run([0.0, 0.0, 0.05], 1.0, clock, thr, on, off)
    assert log[0] == ("on", 100.0, 2)           # both due at 0, one step
    assert log[1][0] == "off"                    # nothing due: offline
    # the request due at 0.05 waited behind the offline step
    assert abs(rec.start[2] - (log[1][1] - 100.0 + 0.3)) < 1e-9
    assert abs(thr.fed[0] - 1.0) < 1e-9          # slowdown over base


def test_waits_are_at_most_a_quantum():
    clock, thr = FakeClock(), Throttle(grant=False)
    log, on, off = make(clock)
    rec = run([0.5], 1.0, clock, thr, on, off)
    assert clock.sleeps and max(clock.sleeps) <= 0.01 + 1e-12
    assert all(e[0] == "on" for e in log)
    assert abs(rec.start[0] - 0.5) < 0.011


def test_batch_cap_and_fifo():
    clock, thr = FakeClock(), Throttle(grant=False)
    log, on, off = make(clock)
    rec = run([0.0] * 11, 1.0, clock, thr, on, off)
    assert [e[2] for e in log] == [8, 3]
    assert (np.diff(rec.end) >= 0).all()


def test_requests_waiting_at_the_close_are_served_late():
    clock, thr = FakeClock(), Throttle()
    log, on, off = make(clock, offline_s=0.5)
    rec = run([0.05, 0.7, 0.95], 1.0, clock, thr, on, off)
    assert not np.isnan(rec.end).any()
    # the last two came while an offline step ran across the close
    assert rec.end[2] > 1.0 and rec.latency[2] > 0.05
    tokens = loop.offline_tokens(rec, 100)
    full = [s for s in rec.spans if s.kind == "offline" and s.end <= 1.0]
    cut = [s for s in rec.spans if s.kind == "offline" and s.start < 1.0 < s.end]
    share = sum((1.0 - s.start) / (s.end - s.start) for s in cut)
    assert abs(tokens - 100 * (len(full) + share)) < 1e-9


def test_trace_marks_the_last_stretch():
    clock, thr = FakeClock(), Throttle()
    log, on, off = make(clock)
    seen = []

    def on_turn(t):
        seen.append(t)
        return t is not None and t >= 0.6
    rec = loop.run_window(np.array([0.1, 0.7]), 1.0, on, off, thr,
                          max_batch=8, quantum=0.01, base_s=0.01,
                          slo_slowdown=1.25, clock=clock, on_turn=on_turn)
    assert seen[-1] is None
    assert rec.trace_from is not None and rec.trace_from >= 0.6
    assert list(rec.traced_req) == [False, True]
    assert all(s.traced == (s.start >= rec.trace_from)
               for s in rec.spans if s.start < 1.0)


def test_trace_summary_names_idle_gaps_by_step():
    """Busy time is the union of the device's operations; each idle gap
    goes to the loop's step and the runtime call at its middle."""
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, a, b, name, dev):
            self.a, self.b, self.n, self.d = a, b, name, dev

        def start_ns(self):
            return self.a

        def end_ns(self):
            return self.b

        def name(self):
            return self.n

        def device_type(self):
            return self.d
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Ev(0, 40, "gemm", cuda), Ev(30, 50, "gemm", cuda),
              Ev(80, 100, "void k<int>(float*)", cuda),
              Ev(55, 70, "cudaLaunchKernel", cpu)]
    steps = [(0, 60, "mux.offline"), (75, 100, "mux.online")]
    got = trace.summarize(events, steps)
    assert got["busy_s"] == approx(70e-9) and got["window_s"] == approx(100e-9)
    # a kernel's time is its own calls' (overlapping ones each count)
    assert got["kernels"] == approx({"gemm": 60e-9, "k<int>": 20e-9})
    assert got["busy_by_step"] == approx({"mux.offline": 50e-9,
                                          "mux.online": 20e-9})
    # the gap 50-80: its middle, 65, lies in no step, in the launch call
    (name, secs), = got["breakdown"]["idle_gaps"]
    assert name == "mux.loop/cudaLaunchKernel" and secs == approx(30e-9)
