"""The port's span log (`repro_torch.obs.spans`) and the throttle's
counters, on the CPU at h2o-danube-1.8b's SMOKE size: nothing recorded
while detached, the spans of a decode step and of a train step nested as
the steps are, the same outputs attached and detached, the cap, and
`KernelThrottle`'s granted and refused quanta."""
import threading

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.protection import KernelThrottle
from repro_torch.models import (init_cache, init_params, make_decode_step,
                                make_prefill, make_train_step)
from repro_torch.obs import spans
from repro_torch.optim import AdamW, AdamWConfig

ARCH = "h2o-danube-1.8b"
B, PROMPT, ROWS = 2, 8, 16


@pytest.fixture(autouse=True)
def detached():
    spans.detach()
    yield
    spans.detach()


def model():
    cfg = get_config(ARCH, smoke=True, dtype=torch.float32)
    return cfg, init_params(torch.Generator().manual_seed(0), cfg)


def decode_once(attached: bool):
    """One decode step after a prefill: (logits, cache, the log or None)."""
    cfg, params = model()
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=g)
    _, pre = make_prefill(cfg)(params, {"tokens": prompt})
    cache = init_cache(cfg, B, ROWS, device="cpu")
    for src, dst in zip(pre, cache):
        for name, t in src.items():
            dst[name][:, :, :t.shape[2]].copy_(t)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    if attached:
        spans.attach()
    logits, cache = make_decode_step(cfg)(params, cache, tok, PROMPT)
    return cfg, logits, cache, spans.detach()


def train_once(attached: bool):
    """One AdamW step: (loss, weights, moments, the log or None)."""
    cfg, params = model()
    opt = AdamW(AdamWConfig(lr=1e-2, warmup_steps=1))
    state = opt.init(params.parameters())
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(2))
    if attached:
        spans.attach()
    params, state, met = make_train_step(cfg, opt)(params, state,
                                                   {"tokens": toks})
    return (met["loss"], list(params.parameters()), state["m"] + state["v"],
            spans.detach())


def children(log, i):
    return [j for j, s in enumerate(log) if s.parent == i]


def inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_detached_records_nothing():
    a, b = spans.span("decode.step"), spans.span("train.step")
    assert a is b is spans._OFF
    with a as entered:
        assert entered is a
    decode_once(attached=False)
    assert spans.detach() is None


def test_decode_step_spans_nest_as_the_step():
    cfg, _, _, log = decode_once(attached=True)
    got = log.spans()
    assert log.dropped == 0 and all(s.end_ns is not None for s in got)
    (top,) = [i for i, s in enumerate(got) if s.parent == -1]
    assert got[top].name == "decode.step"
    kids = children(got, top)
    assert [got[i].name for i in kids] == (
        ["decode.prepare"] + ["decode.layer"] * cfg.num_layers
        + ["decode.head"])
    for i in kids[1:-1]:
        (att,) = children(got, i)
        assert got[att].name == "decode.attention"
        assert not children(got, att) and inside(got[att], got[i])
    for i in kids:
        assert inside(got[i], got[top])
    starts = [got[i].start_ns for i in kids]
    ends = [got[i].end_ns for i in kids]
    assert all(e <= s for e, s in zip(ends, starts[1:]))
    assert len(got) == 3 + 2 * cfg.num_layers


def test_train_step_spans_nest_as_the_step():
    *_, log = train_once(attached=True)
    got = log.spans()
    assert [s.name for s in got] == ["train.step", "train.forward",
                                     "train.backward", "train.optimizer"]
    assert [s.parent for s in got] == [-1, 0, 0, 0]
    assert all(inside(s, got[0]) for s in got[1:])
    for a, b in zip(got[1:], got[2:]):
        assert a.end_ns <= b.start_ns


@pytest.mark.parametrize("step", ["decode", "train"])
def test_outputs_equal_attached_and_detached(step):
    if step == "decode":
        _, l0, c0, _ = decode_once(attached=False)
        _, l1, c1, log = decode_once(attached=True)
        assert log.opened > 0 and torch.equal(l0, l1)
        for a, b in zip(c0, c1):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
    else:
        loss0, w0, mom0, _ = train_once(attached=False)
        loss1, w1, mom1, log = train_once(attached=True)
        assert log.opened == 4 and torch.equal(loss0, loss1)
        assert all(torch.equal(a, b) for a, b in zip(w0 + mom0, w1 + mom1))


def test_cap_counts_the_dropped_spans(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    log = spans.attach()
    for _ in range(5):
        with spans.span("outer"):
            with spans.span("inner"):
                pass
    assert spans.detach() is log
    got = log.spans()
    assert [s.name for s in got] == ["outer", "inner", "outer"]
    assert [s.parent for s in got] == [-1, 0, -1]
    assert log.opened == 10 and log.dropped == 7


def test_parents_are_of_the_same_thread():
    log = spans.attach()
    started, go = threading.Event(), threading.Event()

    def other():
        with spans.span("worker"):
            started.set()
            go.wait(timeout=10)
    t = threading.Thread(target=other)
    with spans.span("main"):
        t.start()
        assert started.wait(timeout=10)
        with spans.span("main.child"):
            pass
        go.set()
        t.join(timeout=10)
    assert not t.is_alive()
    by_name = {s.name: s for s in spans.detach().spans()}
    names = [s.name for s in log.spans()]
    assert by_name["worker"].parent == -1
    assert names[by_name["main.child"].parent] == "main"


@pytest.mark.parametrize("frozen", [False, True])
def test_throttle_counts_each_quantum(frozen):
    thr = KernelThrottle()
    thr.duty = 0.3
    if frozen:
        thr.freeze()
    calls, granted = 50, 0
    for _ in range(calls):
        granted += thr.should_launch(0.01)
    assert thr.granted == granted and thr.granted + thr.refused == calls
    if frozen:
        assert thr.refused == calls
    else:
        assert 0 < thr.granted < calls
