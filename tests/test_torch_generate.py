"""The port's serving modes against the JAX package: the mLSTM decode step,
prefill (logits and every cache leaf, the ring-aligned window cache
included), greedy generation for every ported architecture, the eval step,
the serving engine on the mLSTM pattern (slot reuse, F5 in ROADMAP.md) and
the serve entry point's default; JAX weights carried across through numpy.

JAX is imported inside the helpers, so that the module also imports where
only PyTorch is installed and the card-only cases can run there."""
import contextlib
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import (forward, greedy_generate, init_cache,
                                init_params, make_decode_step,
                                make_eval_step, make_prefill)
from repro_torch.models import ssm as S
from repro_torch.serving.engine import EngineConfig, ServeRequest, ServingEngine

ARCHS = ["mistral-nemo-12b", "h2o-danube-1.8b", "h2o-danube-3-4b",
         "gemma-7b", "xlstm-350m"]
# the reference's limits: fp32 2e-5 (tests/test_kernels.py:12), the mLSTM's
# 1e-4 relative in fp32, bf16 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLSTM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a multiplexer SLO so loose that neither the PID's setpoint (the measured
# slowdown) nor the eviction budget (slo x base step x 4) is ever reached,
# so offline steps run whatever the host's load makes the steps take;
# arrivals over some 2 s (a 3 s horizon), and the port's side on one
# thread (one_torch_thread), so that one offline step slowed by a loaded
# host does not run past the horizon before any request is served
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


def tol(arch: str, dtype: str) -> float:
    return (MLSTM_TOL if arch == "xlstm-350m" else TOL)[dtype]


@functools.cache
def ref():
    """The JAX package's pieces these tests compare with."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.launch.serve import run as jax_run
    from repro.models import forward as jax_forward
    from repro.models import init_cache as jax_init_cache
    from repro.models import init_params as jax_init_params
    from repro.models import ssm as JS
    from repro.models import steps as jax_steps
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    from repro.serving.engine import ServeRequest as JaxServeRequest
    from repro.serving.engine import ServingEngine as JaxServingEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config, run=jax_run,
        forward=jax_forward, init_cache=jax_init_cache,
        init_params=jax_init_params, ssm=JS,
        steps=jax_steps, EngineConfig=JaxEngineConfig,
        ServeRequest=JaxServeRequest, ServingEngine=JaxServingEngine)


@functools.cache
def carry(arch: str, dtype: str):
    """(jcfg, jparams, cfg, model): `repro`'s SMOKE model from PRNGKey(0)
    and the port's holding the same weights, on the CPU."""
    from repro_torch.models.convert import params_from_jax
    J = ref()
    jcfg = dataclasses.replace(J.get_config(arch, smoke=True),
                               dtype=getattr(J.jnp, dtype))
    jparams = J.init_params(J.jax.random.PRNGKey(0), jcfg)
    cfg = get_config(arch, smoke=True, dtype=getattr(torch, dtype))
    model = params_from_jax(J.jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def tokens(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------- mLSTM decode

@pytest.mark.parametrize("steps", [1, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_step_matches_jax(dtype, steps):
    """Block 0's mixer from the initial state, fed `steps` tokens one at a
    time: each output and the final state (C, n, m, conv)."""
    J = ref()
    jcfg, jparams, cfg, model = carry("xlstm-350m", dtype)
    jmix = J.jax.tree.map(lambda a: a[0], jparams["blocks"][0])["mixer"]
    mix = model.blocks[0].mixer
    B = 3
    jst = J.ssm.mlstm_state_init(B, jcfg)
    st = S.mlstm_state_init(B, cfg, "cpu")
    rng = np.random.default_rng(1)
    t = MLSTM_TOL[dtype]
    for i in range(steps):
        x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        want, jst = J.ssm.mlstm_decode_step(
            jmix, J.jnp.asarray(x).astype(jcfg.dtype), jst, jcfg)
        got, st = S.mlstm_decode_step(mix, torch.from_numpy(x).to(cfg.dtype),
                                      st, cfg)
        assert got.dtype == cfg.dtype and tuple(got.shape) == (B, 1,
                                                               cfg.d_model)
        np.testing.assert_allclose(f32(got), f32(want), atol=t, rtol=t,
                                   err_msg=f"step {i}")
    for name, g, w in zip("Cnm", st["carry"], jst["carry"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(f32(g), f32(w), atol=t, rtol=t,
                                   err_msg=name)
    assert st["conv"].dtype == cfg.dtype
    np.testing.assert_allclose(f32(st["conv"]), f32(jst["conv"]), atol=t,
                               rtol=t)


def test_mlstm_cache_layout_matches_jax():
    jcfg, _, cfg, _ = carry("xlstm-350m", "float32")
    want = ref().init_cache(jcfg, 3, 64)[0]
    got = init_cache(cfg, 3, 64, device="cpu")[0]
    assert set(got) == set(want) == {"C", "n", "m", "conv"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_array_equal(f32(got[name]), f32(want[name]))
    assert float(got["m"].max()) == -60.0


# --------------------------------------------------------------------- prefill

# (arch, S): the dense pattern with no window; h2o-danube-1.8b SMOKE's window
# of 16 with S below, at and past it (37 % 16 = 5: the ring-aligned roll);
# h2o-danube-3-4b's d 120 past its window of 16 and gemma-7b's GELU MHA; the
# mLSTM over three chunks of 8 and a ragged last chunk
PREFILL_CASES = [("mistral-nemo-12b", 12), ("h2o-danube-1.8b", 8),
                 ("h2o-danube-1.8b", 16), ("h2o-danube-1.8b", 37),
                 ("h2o-danube-3-4b", 21), ("gemma-7b", 21),
                 ("xlstm-350m", 24), ("xlstm-350m", 13)]


def prefill_both(arch: str, S: int, dtype: str):
    J = ref()
    jcfg, jparams, cfg, model = carry(arch, dtype)
    toks = tokens(cfg, 2, S)
    want, jcache, _ = J.forward(jparams, jcfg, {"tokens": J.jnp.asarray(toks)},
                                mode="prefill")
    got, cache, aux = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                              mode="prefill")
    assert float(aux) == 0.0
    assert tuple(got.shape) == (2, cfg.padded_vocab) and got.dtype == cfg.dtype
    assert len(cache) == len(jcache) == 1
    assert set(cache[0]) == set(jcache[0])
    for name, leaf in cache[0].items():
        assert tuple(leaf.shape) == jcache[0][name].shape, name
        assert str(leaf.dtype).split(".")[1] == str(jcache[0][name].dtype)
    if cfg.window is not None:
        assert cache[0]["k"].shape[2] == min(S, cfg.window)
    return cfg, got, want, cache[0], jcache[0]


@pytest.mark.parametrize("arch,S", PREFILL_CASES)
def test_prefill_matches_jax(arch, S):
    """fp32: the last-token logits and every cache leaf, elementwise."""
    _, got, want, cache, jcache = prefill_both(arch, S, "float32")
    t = tol(arch, "float32")
    np.testing.assert_allclose(f32(got), f32(want), atol=t, rtol=t)
    for name, leaf in cache.items():
        np.testing.assert_allclose(f32(leaf), f32(jcache[name]), atol=t,
                                   rtol=t, err_msg=name)


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole array."""
    got, want = f32(got), f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("arch,S", PREFILL_CASES)
def test_prefill_bf16_matches_jax(arch, S):
    """bf16: the last-token logits and every cache leaf of every layer within
    2e-2 of `repro`'s by relative norm, ||port - ref|| / ||ref||; a wrong
    mask, window or ring roll moves them by far more.  Elementwise, the two
    frameworks' bf16 roundings compound over the layers and put a few values
    of the logits and the later layers' k and v a few ulps past 2e-2 (up to
    1.9 times the limit, CHANGES.md), as far from each other as either is
    from the fp32 model.  What both packages compute with the same roundings
    is also held elementwise within 2e-2: the mLSTM state of every layer and
    the first layer's k and v (projection and rotary, before any
    attention)."""
    cfg, got, want, cache, jcache = prefill_both(arch, S, "bfloat16")
    t = TOL["bfloat16"]
    assert rel_err(got, want) <= t
    for name, leaf in cache.items():
        assert rel_err(leaf, jcache[name]) <= t, name
        if name in ("k", "v"):
            leaf, jleaf = leaf[0], jcache[name][0]
        else:
            jleaf = jcache[name]
        np.testing.assert_allclose(f32(leaf), f32(jleaf), atol=t, rtol=t,
                                   err_msg=name)


@pytest.mark.parametrize("arch,S", [("mistral-nemo-12b", 9),
                                    ("h2o-danube-1.8b", 21),
                                    ("gemma-7b", 9), ("xlstm-350m", 11)])
def test_prefill_then_decode_matches_train_logits(arch, S):
    """The port against itself: prefill S tokens, then decode N more against
    a cache with room for them, the logits at each position equal to the
    train forward's over the whole sequence (h2o-danube-1.8b's prompt is
    past its window: decode runs on the ring the prefill aligned)."""
    from repro_torch.models.steps import _copy_prefix_cache
    _, _, cfg, model = carry(arch, "float32")
    N = 7
    toks = torch.from_numpy(tokens(cfg, 2, S + N, seed=2))
    train, _ = forward(model, cfg, {"tokens": toks}, mode="train")
    logits, pre = make_prefill(cfg)(model, {"tokens": toks[:, :S]})
    t = tol(arch, "float32")
    np.testing.assert_allclose(f32(logits), f32(train[:, S - 1]), atol=t,
                               rtol=t)
    cache = _copy_prefix_cache(pre, init_cache(cfg, 2, S + N, device="cpu"))
    decode = make_decode_step(cfg)
    for i in range(N):
        logits, cache = decode(model, cache, toks[:, S + i:S + i + 1], S + i)
        np.testing.assert_allclose(f32(logits), f32(train[:, S + i]), atol=t,
                                   rtol=t, err_msg=f"position {S + i}")


# ------------------------------------------------------------------ generation

@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    """SMOKE in fp32, a batch of 2 prompts of 20 tokens (past the window of
    16 for the h2o-danube models) and 8 greedy steps: the same token ids."""
    J = ref()
    jcfg, jparams, cfg, model = carry(arch, "float32")
    toks = tokens(cfg, 2, 20, seed=3)
    want = J.steps.greedy_generate(jcfg, jparams,
                                   {"tokens": J.jnp.asarray(toks)}, 8)
    got = greedy_generate(cfg, model, {"tokens": torch.from_numpy(toks)}, 8)
    assert tuple(got.shape) == (2, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma-7b",
                                  "xlstm-350m"])
def test_eval_step_matches_jax(arch):
    J = ref()
    jcfg, jparams, cfg, model = carry(arch, "float32")
    batch = {"tokens": tokens(cfg, 2, 16, seed=4)}
    want = J.steps.make_eval_step(jcfg)(jparams, batch)
    got = make_eval_step(cfg)(model, batch)
    assert set(got) == set(want) == {"loss", "ce"}
    for key in got:
        assert not got[key].requires_grad
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=MLSTM_TOL["float32"])


# ---------------------------------------------------------------- the engine

def mlstm_engine_tokens(make_req, make_eng, prompts, new, slots):
    reqs = [make_req(i, p.astype(np.int32), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]
    eng = make_eng(slots)
    for r in reqs:
        eng.submit(r)
    eng.drain()
    return eng, [r.output for r in reqs]


def test_engine_serves_mlstm_like_jax():
    """xlstm-350m SMOKE in fp32: seven ragged requests through three slots,
    so that slots are freed and reused: the same tokens and steps as
    `repro`'s engine, stale mLSTM state and all (F5)."""
    J = ref()
    jcfg, jparams, cfg, model = carry("xlstm-350m", "float32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 10)))
               for _ in range(7)]
    new = [int(rng.integers(2, 7)) for _ in range(7)]
    jeng, want = mlstm_engine_tokens(
        J.ServeRequest, lambda n: J.ServingEngine(
            jcfg, jparams, J.EngineConfig(num_slots=n, kv_capacity=64)),
        prompts, new, 3)
    eng, got = mlstm_engine_tokens(
        ServeRequest, lambda n: ServingEngine(
            cfg, model, EngineConfig(num_slots=n, kv_capacity=64)),
        prompts, new, 3)
    assert got == want and eng.steps == jeng.steps
    assert [len(o) for o in got] == new


def test_engine_keeps_stale_mlstm_state_on_slot_reuse():
    """F5 pinned: one slot, two requests of 5-token prompts and 6 new tokens.
    The first matches `greedy_generate`; the second starts from the state
    the first left and does not, in the port as in `repro`."""
    J = ref()
    jcfg, jparams, cfg, model = carry("xlstm-350m", "float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 5) for _ in range(2)]
    alone = [greedy_generate(cfg, model, {"tokens": torch.from_numpy(p)[None]},
                             5)[0].tolist() for p in prompts]
    assert alone == [[5, 97, 210, 200, 13, 125], [108, 181, 29, 111, 203, 76]]
    _, want = mlstm_engine_tokens(
        J.ServeRequest, lambda n: J.ServingEngine(
            jcfg, jparams, J.EngineConfig(num_slots=n, kv_capacity=64)),
        prompts, [6, 6], 1)
    _, got = mlstm_engine_tokens(
        ServeRequest, lambda n: ServingEngine(
            cfg, model, EngineConfig(num_slots=n, kv_capacity=64)),
        prompts, [6, 6], 1)
    assert got == want == [[5, 97, 210, 200, 13, 125],
                           [56, 158, 56, 97, 198, 64]]


# ------------------------------------------------------------ serve entry point

def test_serve_main_defaults_to_xlstm(monkeypatch):
    seen = {}

    def fake_run(arch, **kw):
        seen.update(kw, arch=arch)
        return {"base_ms": 1.0, "p50_ms": 1.0, "p99_ms": 1.0, "served": 1,
                "offline_steps": 0, "oversold": 0.0}

    monkeypatch.setattr(serve, "run", fake_run)
    serve.main([])
    assert seen["arch"] == "xlstm-350m" and seen["smoke"] is True
    assert seen["device"] is None          # the card unless asked


def test_serve_cli_serves_xlstm_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "5"])
    out = capsys.readouterr().out
    assert "[serve]" in out and "served=5" in out


def test_serve_share_runs_offline_steps_for_xlstm():
    """`run("xlstm-350m", share=True)` packs AdamW steps of the mLSTM beside
    its decode steps, here and in `repro`, under conditions the host's
    load cannot decide (LOOSE_SLO, SHARE_QPS, one_torch_thread)."""
    J = ref()
    with one_torch_thread():
        out = serve.run("xlstm-350m", smoke=True, device="cpu", share=True,
                        requests=20, qps=SHARE_QPS, slo=LOOSE_SLO)
    want = J.run("xlstm-350m", smoke=True, share=True, requests=20,
                 qps=SHARE_QPS, slo=LOOSE_SLO)
    assert set(out) == set(want) | {"decode_steps"}
    for o in (out, want):
        assert o["served"] >= 1 and o["offline_steps"] >= 1
        assert o["train_steps_done"] == o["offline_steps"] + 2


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_generation_on_card_match_cpu(arch):
    """SMOKE in fp32, the same weights on the card (through the kernels) and
    on the CPU (their plain versions): prefill logits within 1e-4 and the
    same greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = init_params(torch.Generator().manual_seed(0), cfg).to("cuda")
    toks = torch.from_numpy(tokens(cfg, 2, 20, seed=6))
    want, _ = make_prefill(cfg)(cpu, {"tokens": toks})
    before = (fa.launches, da.launches)
    got, _ = make_prefill(cfg)(gpu, {"tokens": toks.cuda()})
    np.testing.assert_allclose(f32(got.cpu()), f32(want), atol=1e-4,
                               rtol=1e-4)
    gen = greedy_generate(cfg, gpu, {"tokens": toks.cuda()}, 8)
    assert torch.equal(gen.cpu(), greedy_generate(cfg, cpu,
                                                  {"tokens": toks}, 8))
    dense = cfg.pattern != (("mlstm", "none"),)
    assert fa.launches - before[0] == (2 * cfg.num_layers if dense else 0)
    assert da.launches - before[1] == (8 * cfg.num_layers if dense else 0)
