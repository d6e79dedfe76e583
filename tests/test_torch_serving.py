"""The port's serving front end against the JAX package: the continuous-
batching engine with carried weights, the multiplexer, and the online
serve entry point (all on the CPU)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.multiplexer import Multiplexer as JaxMultiplexer
from repro.core.multiplexer import MuxConfig as JaxMuxConfig
from repro.launch.serve import run as jax_run
from repro.models import init_params as jax_init_params
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeRequest as JaxServeRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.core.multiplexer import Multiplexer, MuxConfig
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import EngineConfig, ServeRequest, ServingEngine

ARCH = "mistral-nemo-12b"
# the shared run under conditions the host's load cannot decide: an SLO
# that the measured slowdown of a step never reaches, arrivals over some
# 2 s (a 3 s horizon) that one slowed offline step does not skip, and the
# port's side on one thread (one_torch_thread)
LOOSE_SLO = 1e6
SHARE_QPS = 10.0


@contextlib.contextmanager
def one_torch_thread():
    """The port's shared run on one intra-op thread.  With a thread a core
    and the other test workers busy, OpenMP's barriers wait on descheduled
    threads: a SMOKE AdamW step of 40 ms alone took over 5 s, past the
    whole horizon, and no request was served.  On one thread a loaded host
    slows a step by its share of the cores only."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def ragged_requests(make, vocab, seed=1, n=6, prompt=(2, 9), new=(2, 6)):
    """tests/test_serving_engine.py's ragged batch (prompt and new-token
    counts drawn from the given ranges)."""
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(0, vocab, int(rng.integers(*prompt))).astype(np.int32),
                 max_new_tokens=int(rng.integers(*new)))
            for i in range(n)]


# h2o-danube-1.8b SMOKE has a window of 16: its requests run past it, so
# the engine decodes on the ring cache
@pytest.mark.parametrize("arch,lengths", [
    (ARCH, {}),
    ("h2o-danube-1.8b", {"prompt": (10, 21), "new": (8, 14)}),
])
def test_engine_greedy_tokens_match_jax(arch, lengths):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")

    jreqs = ragged_requests(JaxServeRequest, cfg.vocab_size, **lengths)
    jeng = JaxServingEngine(jcfg, jparams,
                            JaxEngineConfig(num_slots=3, kv_capacity=64))
    reqs = ragged_requests(ServeRequest, cfg.vocab_size, **lengths)
    eng = ServingEngine(cfg, model, EngineConfig(num_slots=3, kv_capacity=64))
    if cfg.window is not None:             # every request runs past the ring
        assert eng.cache[0]["k"].shape[2] == cfg.window < min(
            len(r.prompt) + r.max_new_tokens for r in reqs)
    for e, rs in ((jeng, jreqs), (eng, reqs)):
        for r in rs:
            e.submit(r)
        e.drain()
    assert eng.steps == jeng.steps
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert all(len(r.output) == r.max_new_tokens for r in reqs)


def test_engine_rejects_request_beyond_capacity():
    cfg = get_config(ARCH, smoke=True, dtype=torch.float32)
    eng = ServingEngine(cfg, init_params(torch.Generator().manual_seed(0), cfg),
                        EngineConfig(num_slots=1, kv_capacity=8))
    with pytest.raises(ValueError, match="kv_capacity"):
        eng.submit(ServeRequest(0, np.arange(4, dtype=np.int32), 4))


def _mux_stats(mux_cls, cfg_cls, case):
    holder = {}

    def online_fn(bs):                  # slowed by the offline duty
        return 0.010 * (1.0 + 0.5 * holder["m"].throttle.duty)

    kw = dict(slo_slowdown=1.2)
    if case == "evict":
        online_fn = lambda bs: 0.05    # noqa: E731
        kw["evict_after_violations"] = 10
    m = mux_cls(online_fn, lambda: 0.020, 0.010, 0.020, cfg_cls(**kw))
    holder["m"] = m
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1 / 40, 300)).tolist()
    if case == "idle":
        return dataclasses.asdict(m.run([], 5.0, max_offline_steps=10))
    return dataclasses.asdict(m.run(arrivals, 10.0))


@pytest.mark.parametrize("case", ["load", "idle", "evict"])
def test_multiplexer_matches_jax_package(case):
    assert (_mux_stats(Multiplexer, MuxConfig, case)
            == _mux_stats(JaxMultiplexer, JaxMuxConfig, case))


def test_serve_run_returns_reference_keys():
    out = serve.run(ARCH, smoke=True, device="cpu", requests=20)
    ref = jax_run(ARCH, smoke=True, requests=20)
    assert set(out) == set(ref) | {"decode_steps"}
    assert out["served"] == ref["served"] == 20
    assert out["offline_steps"] == ref["offline_steps"] == 0
    assert out["decode_steps"] >= 6 and out["base_ms"] > 0


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "5"])
    assert "[serve]" in capsys.readouterr().out


def test_serve_share_needs_the_train_slice():
    """`--share` packs AdamW train steps of the served architecture beside
    its decode steps, here and in `repro` (wall-clock driven, so the
    structure only): one warm-up and one timed step, then the
    multiplexer's.  Run under LOOSE_SLO, SHARE_QPS and one_torch_thread,
    so that whether offline steps and requests run does not depend on how
    loaded the host is."""
    arch = "h2o-danube-1.8b"
    with one_torch_thread():
        out = serve.run(arch, smoke=True, device="cpu", share=True,
                        requests=20, qps=SHARE_QPS, slo=LOOSE_SLO)
    ref = jax_run(arch, smoke=True, share=True, requests=20, qps=SHARE_QPS,
                  slo=LOOSE_SLO)
    assert set(out) == set(ref) | {"decode_steps"}
    for o in (out, ref):
        assert o["served"] >= 1 and o["offline_steps"] >= 1
        assert o["train_steps_done"] == o["offline_steps"] + 2
