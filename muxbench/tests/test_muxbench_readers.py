"""The readers of the program's spans and counters, on a synthetic
traced run: the counters' deltas over the window before the traced
stretch, and the device time of a step's spans from the join."""
from types import SimpleNamespace

from pytest import approx

from conftest import ROOT

from muxbench import bench, loop
from muxbench import spans as S


def reader(name):
    return bench.load_module(ROOT / "muxbench" / "metrics" / f"{name}.py")


def record(online: int, traced_online: int):
    spans = [loop.Span("online", i, i + 0.5, 1, i) for i in range(online)]
    spans += [loop.Span("online", 100 + i, 100.5 + i, 1, online + i,
                        traced=True) for i in range(traced_online)]
    return SimpleNamespace(spans=spans, trace_from=100.0, seconds=110.0)


def test_counter_deltas():
    window = {"granted": 10, "refused": 4, "replays": 26, "eager": 1,
              "captures": 4}
    traced = {"granted": 40, "refused": 24, "replays": 326, "eager": 1,
              "captures": 4}
    close = {"granted": 45, "refused": 30, "replays": 380, "eager": 1,
             "captures": 4}
    assert bench.delta(window, traced) == {"granted": 30, "refused": 20,
                                           "replays": 300, "eager": 0,
                                           "captures": 0}
    rd = SimpleNamespace(rec=record(300, 54), counters={
        "before": bench.delta(window, traced),
        "traced": bench.delta(traced, close)})
    assert reader("offline_quanta_refused_pct").read(rd) == approx(40.0)
    assert reader("decode_replay_pct").read(rd) == approx(100.0)
    # an online step run eagerly is not a replay
    rd.counters["before"]["replays"] = 270
    assert reader("decode_replay_pct").read(rd) == approx(90.0)
    # nothing asked, no step, or no counters: nothing to read
    rd.counters["before"].update(granted=0, refused=0)
    assert reader("offline_quanta_refused_pct").read(rd) is None
    assert reader("decode_replay_pct").read(SimpleNamespace(
        rec=record(0, 3), counters=rd.counters)) is None
    assert reader("decode_replay_pct").read(SimpleNamespace(
        rec=record(3, 0), counters=None)) is None


def test_span_readers_take_device_ms_a_step():
    """Two train steps' forward, backward and optimizer, and two online
    steps, each with their kernels; device ms a span, children
    included."""
    from test_muxbench_spans import Ev, launch
    spans, events, cid = [], [], 0
    for k in range(2):
        t = 1000 * k
        spans += [("train.step", t, t + 400, -1)]
        top = len(spans) - 1
        for j, (name, ms) in enumerate([("train.forward", 10),
                                        ("train.backward", 30),
                                        ("train.optimizer", 20)]):
            a = t + 10 + 100 * j
            spans.append((name, a, a + 90, top))
            cid += 1
            events += launch(cid, a + 5, "gemm", a + 10, a + 10 + ms * 10**6)
        spans += [("decode.step", t + 500, t + 600, -1),
                  ("decode.replay", t + 540, t + 560, len(spans))]
        cid += 1
        events += [Ev(t + 545, t + 547, "cudaGraphLaunch", cid=cid),
                   Ev(t + 550, t + 550 + 3 * 10**6, "decode_partial<64>",
                      cuda=True, cid=cid),
                   Ev(t + 551, t + 551 + 2 * 10**6, "gemm", cuda=True,
                      cid=cid)]
    rd = SimpleNamespace(spans=S.join(events, spans))
    assert reader("train_step.forward_ms").read(rd) == approx(10.0)
    assert reader("train_step.backward_ms").read(rd) == approx(30.0)
    assert reader("train_step.optimizer_ms").read(rd) == approx(20.0)
    assert reader("decode_step.device_ms").read(rd) == approx(5.0)
    # no device operations (a run on the CPU), or no spans: None
    cpu = SimpleNamespace(spans=S.join([e for e in events if not e.cuda],
                                       spans))
    none = SimpleNamespace(spans=None)
    for name in ("train_step.forward_ms", "decode_step.device_ms"):
        assert reader(name).read(cpu) is None
        assert reader(name).read(none) is None
