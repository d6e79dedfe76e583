"""The join of the program's spans to the device trace
(`muxbench/spans.py`), on synthetic profiler events: kernels go to the
innermost span that holds their launch, whatever the thread; self times
and counts; the clock check, for kernels launched one by one and for a
replayed CUDA graph's; a trace without device operations; and the port's
own span log as the join takes it."""
import time

import pytest
from pytest import approx

from muxbench import spans as S


class Ev:
    """A profiler event as `torch.profiler`'s kineto results give it."""

    def __init__(self, a, b, name, cuda=False, cid=0, tid=1):
        self.a, self.b, self.n, self.cuda, self.cid, self.tid = (
            a, b, name, cuda, cid, tid)

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def name(self):
        return self.n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def correlation_id(self):
        return self.cid

    def start_thread_id(self):
        return self.tid


def launch(cid, at, kernel, k0, k1, tid=1):
    """A runtime call at `at` and the kernel it launched, from k0 to k1."""
    return [Ev(at, at + 2, "cudaLaunchKernel", cid=cid, tid=tid),
            Ev(k0, k1, kernel, cuda=True, cid=cid)]


# one decode step (0-100) with one layer and its attention, then one train
# step (200-400) whose backward's kernels come from a second thread
SPANS = [("decode.step", 0, 100, -1), ("decode.layer", 10, 80, 0),
         ("decode.attention", 30, 50, 1), ("train.step", 200, 400, -1),
         ("train.forward", 205, 250, 3), ("train.backward", 255, 350, 3),
         ("train.optimizer", 355, 395, 3)]
EVENTS = (launch(1, 5, "embed", 90, 95)
          + launch(2, 20, "gemm", 96, 110)
          + launch(3, 35, "decode_partial<128>", 111, 120)
          + launch(4, 60, "gemm", 121, 130)
          + launch(5, 120, "argmax", 131, 133)
          + launch(6, 210, "gemm", 214, 240)
          + launch(7, 260, "gemm_bwd", 262, 300, tid=2)
          + launch(8, 270, "gemm_bwd", 301, 330, tid=2)
          + launch(9, 360, "adamw", 362, 390)
          + [Ev(500, 510, "memset", cuda=True, cid=0)])


def test_kernels_go_to_the_innermost_span_of_their_launch():
    got = S.join(EVENTS, SPANS)
    n = got["names"]
    assert n["decode.attention"]["launches"] == 1
    assert n["decode.attention"]["device_ms"] == approx(9e-6)
    assert n["decode.layer"]["launches"] == 2          # the two gemms
    assert n["decode.layer"]["launches_all"] == 3
    assert n["decode.step"]["launches"] == 1            # the embedding
    assert n["decode.step"]["launches_all"] == 4
    assert n["decode.step"]["device_ms_all"] == approx((5 + 14 + 9 + 9) / 1e6)
    # launched from the autograd engine's thread, inside the main thread's
    # backward span
    assert n["train.backward"]["launches"] == 2
    assert n["train.backward"]["device_ms"] == approx(67e-6)
    assert n["train.step"]["launches"] == 0
    assert n["train.step"]["launches_all"] == 4
    # the argmax (launched between steps) and the memset (no runtime call)
    assert got["outside"] == 1 and got["unlinked"] == 1 and got["ops"] == 10
    assert n["train.step"]["device_ms_all"] == approx((26 + 67 + 28) / 1e6)
    assert "decode.nothing" not in n


def test_self_times_and_counts():
    spans = SPANS + [("decode.step", 500, 560, -1),
                     ("decode.layer", 510, 530, 7),
                     ("decode.layer", 531, 541, 7)]
    n = S.join(EVENTS, spans)["names"]
    assert {k: v["count"] for k, v in n.items()} == {
        "decode.step": 2, "decode.layer": 3, "decode.attention": 1,
        "train.step": 1, "train.forward": 1, "train.backward": 1,
        "train.optimizer": 1}
    assert n["decode.step"]["host_ms"] == approx((100 + 60) / 1e6)
    assert n["decode.step"]["self_host_ms"] == approx((30 + 30) / 1e6)
    assert n["decode.layer"]["self_host_ms"] == approx((50 + 20 + 10) / 1e6)
    assert n["train.step"]["self_host_ms"] == approx((200 - 180) / 1e6)
    # a span left open when the log was detached is not counted
    n2 = S.join(EVENTS, SPANS + [("decode.step", 600, None, -1)])["names"]
    assert n2["decode.step"]["count"] == 1


@pytest.mark.parametrize("shift", [0, 15, 400])
def test_clock_check(shift):
    """1 when the clocks agree; a shift past the attention span's width
    (20 ns here) moves the launch out of it."""
    moved = [(n, a + shift, b + shift, p) for n, a, b, p in SPANS]
    check = S.join(EVENTS, moved)["clock_check"]
    assert check == (1.0 if shift < 5 else 0.0)


@pytest.mark.parametrize("shift", [0, 30])
def test_clock_check_follows_a_replayed_graph(shift):
    """A replayed step's kernels hang off the one `cudaGraphLaunch` inside
    `decode.replay`: they count as inside while that call lies in the
    span, and go to it and to `decode.step` by their correlation id."""
    spans = [("decode.step", shift, 100 + shift, -1),
             ("decode.replay", 40 + shift, 60 + shift, 0)]
    events = [Ev(45, 47, "cudaGraphLaunch", cid=1),
              Ev(70, 80, "decode_partial<64>", cuda=True, cid=1),
              Ev(81, 90, "decode_partial<64>", cuda=True, cid=1),
              Ev(91, 99, "gemm", cuda=True, cid=1)]
    got = S.join(events, spans)
    n = got["names"]
    assert got["clock_check"] == (1.0 if shift == 0 else 0.0)
    if shift == 0:
        assert n["decode.replay"]["launches"] == 3
        assert n["decode.step"]["launches_all"] == 3
        assert n["decode.step"]["device_ms_all"] == approx(27e-6)
    # a kernel launched on its own must lie in `decode.attention`, even
    # inside `decode.replay`
    alone = launch(2, 50, "decode_partial<64>", 100, 110)
    assert S.join(alone, [("decode.replay", 40, 60, -1)])["clock_check"] \
        == 0.0


def test_without_device_operations_no_device_reading():
    """CPU events alone (a run on the CPU, or runtime calls whose kernels
    the profiler lost): the spans' counts and host times, and no device
    reading."""
    events = [Ev(20, 60, "aten::linear"), Ev(25, 55, "aten::addmm"),
              Ev(35, 37, "cudaLaunchKernel", cid=3),
              Ev(30, 40, "aten::mul", tid=2)]
    got = S.join(events, SPANS)
    assert got["ops"] == 0 and got["clock_check"] is None
    n = got["names"]["decode.layer"]
    assert n["count"] == 1 and n["host_ms"] == approx(70e-6)
    assert n["launches_all"] == 0 and n["device_ms_all"] == 0
    assert "ops=0 " in S.line(got)


def test_no_spans_no_reading():
    assert S.join(EVENTS, []) is None and S.join(EVENTS, None) is None
    assert S.line(None).startswith("[spans] none")
    line = S.line(S.join(EVENTS, SPANS), dropped=3)
    assert "clock_check=1.0" in line and "dropped=3" in line
    assert "decode.step:n=1," in line


def test_the_program_log_joins():
    """The port's span log (`repro_torch.obs.spans`), its spans moved
    onto another clock by an offset as a tracer's would be: a launch
    inside the recorded `decode.attention` goes to it, and the clock
    check reads 1."""
    from repro_torch.obs import spans as P
    P.attach()
    try:
        with P.span("decode.step"):
            with P.span("decode.attention"):
                time.sleep(1e-3)
            with P.span("decode.head"):
                time.sleep(1e-3)
    finally:
        log = P.detach()
    off = 1_700_000_000 * 10**9
    moved = [(s.name, s.start_ns + off, s.end_ns + off, s.parent)
             for s in log.spans()]
    assert [m[0] for m in moved] == ["decode.step", "decode.attention",
                                     "decode.head"]
    (_, a0, a1, _), (_, h0, h1, _) = moved[1], moved[2]
    events = (launch(1, (a0 + a1) // 2, "decode_partial<64>", a1, a1 + 500)
              + launch(2, (h0 + h1) // 2, "gemm", h1, h1 + 900))
    got = S.join(events, moved)
    n = got["names"]
    assert got["clock_check"] == 1.0 and got["outside"] == 0
    assert n["decode.attention"]["launches"] == 1
    assert n["decode.head"]["device_ms"] == approx(900 / 1e6)
    assert n["decode.step"]["launches"] == 0
    assert n["decode.step"]["launches_all"] == 2
    assert n["decode.step"]["host_ms"] >= 2.0


def test_the_summary_stops_at_the_end_of_the_stretch():
    """What the profiler records after `end_stretch` (the job's step after
    the close) is joined to the spans and left out of the summary."""
    from types import SimpleNamespace

    from muxbench import trace as T
    tracer = T.Tracer.__new__(T.Tracer)
    tracer.events, tracer.offset_ns, tracer.end_ns = EVENTS, 0, None
    rec = SimpleNamespace(t0=0.0, spans=[])
    whole = tracer.summary(rec)
    tracer.end_ns = 200                 # before the train step's launches
    cut = tracer.summary(rec)
    assert whole["busy_s"] == approx((39 + 26 + 38 + 29 + 28 + 10) / 1e9)
    assert cut["busy_s"] == approx(39 / 1e9)
    assert cut["window_s"] == approx((133 - 5) / 1e9)
    assert "adamw" in whole["kernels"] and "adamw" not in cut["kernels"]
    # the join keeps every event
    assert S.join(tracer.events, SPANS)["names"]["train.optimizer"][
        "launches"] == 1
