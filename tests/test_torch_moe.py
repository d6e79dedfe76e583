"""The port's MoE and granite-moe-1b-a400m against the JAX package: the
router, the dense oracle and the grouped dispatch piece by piece (slots
dropped past the capacity, the half-to-even capacity, grouped equal to dense
at a large capacity factor, shared experts), then the model at SMOKE in
every mode (train logits and loss with the aux, prefill and its cache,
decode, greedy generation, the serving engine, `serve.run` with and without
`--share`, the training launcher), and the analytic parameter counts of
every ported architecture."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import run as jax_serve_run
from repro.launch.train import run as jax_train_run
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import moe as JM
from repro.models import steps as JS
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeRequest as JaxServeRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import PORTED, get_config
from repro_torch.launch import serve, train
from repro_torch.models import (forward, greedy_generate, init_cache,
                                init_params, loss_fn)
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import EngineConfig, ServeRequest, ServingEngine

ARCH = "granite-moe-1b-a400m"
# the reference's limits (tests/test_kernels.py:12); losses 1e-4 relative
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# tests/test_torch_serving.py's shared-run conditions
LOOSE_SLO = 1e6
SHARE_QPS = 10.0


@functools.cache
def carry(dtype: str = "float32", **overrides):
    """(jcfg, jparams, cfg, model): `repro`'s SMOKE model from PRNGKey(0)
    and the port's holding the same weights, on the CPU."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=getattr(jnp, dtype), **overrides)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(ARCH, smoke=True, dtype=getattr(torch, dtype),
                     **overrides)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def layer0(jparams, model):
    """Block 0's MoE in both packages."""
    return (jax.tree.map(lambda a: a[0], jparams["blocks"][0])["ffn"],
            model.blocks[0].ffn)


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def rel_err(got, want) -> float:
    got, want = f32(got), f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def close(got, want, dtype: str, what: str = "") -> None:
    """fp32 elementwise at 2e-5; bf16 by relative norm at 2e-2 (the two
    frameworks' bf16 roundings compound over the layers, as
    tests/test_torch_generate.py sets out)."""
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=what)
    else:
        assert rel_err(got, want) <= TOL[dtype], what


def hidden(cfg, B: int, S: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), np.float32)


def both(x: np.ndarray, dtype: str):
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def tokens(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ----------------------------------------------------------------- the MoE

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_probs_matches_jax(dtype):
    """The weights (renormalised top-k, fp32), the experts in descending
    order of probability, and the load-balancing aux."""
    jcfg, jparams, cfg, model = carry(dtype)
    jmoe, moe = layer0(jparams, model)
    assert moe.router.dtype == torch.float32
    jx, x = both(hidden(cfg, 3, 16), dtype)
    jw, jidx, jaux = JM.router_probs(jmoe, jx, jcfg)
    w, idx, aux = M.router_probs(moe, x, cfg)
    assert w.dtype == aux.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=2e-5,
                               rtol=2e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_dispatch_matches_jax(dtype):
    jcfg, jparams, cfg, model = carry(dtype)
    jmoe, moe = layer0(jparams, model)
    jx, x = both(hidden(cfg, 2, 12), dtype)
    want, jaux = JM.moe_dense_dispatch(jmoe, jx, jcfg)
    got, aux = M.moe_dense_dispatch(moe, x, cfg)
    assert got.dtype == cfg.dtype
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def dropped(moe, x, cfg, cf: float) -> int:
    """Slots past their expert's capacity in the grouped dispatch."""
    B, S, _ = x.shape
    _, idx, _ = M.router_probs(moe, x, cfg)
    pos = M.slot_positions(idx.reshape(B, -1), cfg.num_experts)
    return int((pos >= M.capacity(S, cfg, cf)).sum())


# (B, S, capacity factor): slots dropped at the default factor; S 8, K 2,
# E 8, the half-to-even capacity round(2.5) = 2; a factor large enough that
# nothing is dropped
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,cf", [(3, 32, 1.25), (4, 8, 1.25),
                                    (2, 16, 100.0)])
def test_grouped_dispatch_matches_jax(dtype, B, S, cf):
    jcfg, jparams, cfg, model = carry(dtype)
    jmoe, moe = layer0(jparams, model)
    jx, x = both(hidden(cfg, B, S, seed=S), dtype)
    want, jaux = JM.moe_grouped_dispatch(jmoe, jx, jcfg, capacity_factor=cf)
    got, aux = M.moe_grouped_dispatch(moe, x, cfg, capacity_factor=cf)
    assert got.dtype == cfg.dtype and tuple(got.shape) == (B, S, cfg.d_model)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    n = dropped(moe, x, cfg, cf)
    if cf == 100.0:
        assert n == 0
    else:
        # a slot is dropped only where its expert's cap rows are all kept,
        # so its zero is added onto the kept slot in row cap - 1: the test
        # shows the scatter-add
        assert n >= 1


def test_capacity_is_repros_half_to_even_round():
    cfg = get_config(ARCH, smoke=True)
    assert (cfg.top_k, cfg.num_experts) == (2, 8)
    assert M.capacity(8, cfg, 1.25) == 2          # round(2.5), not 3
    assert M.capacity(2048, get_config(ARCH), 1.25) == 640
    for S in range(1, 70):
        for cf in (0.5, 1.0, 1.25, 1.5, 2.0, 100.0):
            K, E = cfg.top_k, cfg.num_experts
            want = min(int(max(1, round(-(-S * K // E) * cf))), S * K)
            assert M.capacity(S, cfg, cf) == want, (S, cf)


def test_slot_positions_count_earlier_slots_of_the_expert():
    e_ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5, (3, 40)))
    pos = M.slot_positions(e_ids, 5)
    for b in range(3):
        ids = e_ids[b].tolist()
        want = [ids[:m].count(e) for m, e in enumerate(ids)]
        assert pos[b].tolist() == want


def test_grouped_equals_dense_without_drops():
    """tests/test_models.py:111's property, in the port."""
    _, jparams, cfg, model = carry()
    moe = model.blocks[0].ffn
    x = torch.from_numpy(hidden(cfg, 2, 16))
    yd, auxd = M.moe_dense_dispatch(moe, x, cfg)
    yg, auxg = M.moe_grouped_dispatch(moe, x, cfg, capacity_factor=100.0)
    np.testing.assert_allclose(yg.numpy(), yd.numpy(), atol=2e-5)
    assert float(auxd) == pytest.approx(float(auxg))


def test_decode_rows_are_routed_alone():
    """At S 1 the capacity is 1 and nothing is dropped: a row's output does
    not depend on the other rows of the batch (the engine's ragged slots),
    up to the fp32 limit (a matmul's blocking follows the batch)."""
    _, _, cfg, model = carry()
    moe = model.blocks[0].ffn
    x = torch.from_numpy(hidden(cfg, 6, 1))
    assert M.capacity(1, cfg, cfg.moe_capacity_factor) == 1
    together, _ = M.moe_grouped_dispatch(moe, x, cfg)
    for b in range(6):
        alone, _ = M.moe_grouped_dispatch(moe, x[b:b + 1], cfg)
        np.testing.assert_allclose(alone.numpy(), together[b:b + 1].numpy(),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["grouped", "dense"])
def test_shared_experts_match_jax(impl):
    """A shared expert (deepseek's kind) beside the routed ones."""
    jcfg, jparams, cfg, model = carry(num_shared_experts=1)
    jmoe, moe = layer0(jparams, model)
    assert tuple(moe.shared.w_gate.shape) == (cfg.d_model, cfg.moe_d_ff)
    jx, x = both(hidden(cfg, 2, 8), "float32")
    jfn = JM.moe_grouped_dispatch if impl == "grouped" else \
        JM.moe_dense_dispatch
    fn = M.moe_grouped_dispatch if impl == "grouped" else M.moe_dense_dispatch
    want, _ = jfn(jmoe, jx, jcfg)
    got, _ = fn(moe, x, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()


def test_a2a_dispatch_falls_back_where_experts_do_not_divide_model():
    """`repro`'s fallbacks (moe.py:160-164): on a mesh whose model axis
    does not divide the experts (granite SMOKE's 8 over 3), and with no
    mesh at all, the a2a dispatch is the grouped one, bit for bit."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.sharding import activation_mesh
    _, _, cfg, model = carry()
    moe = model.blocks[0].ffn
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    want, want_aux = M.moe_grouped_dispatch(moe, x, cfg, 1.25)
    assert cfg.num_experts % 3
    with activation_mesh(AbstractMesh((1, 3), ("data", "model"))):
        got, aux = M.moe_a2a_dispatch(moe, x, cfg, 1.25)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    a2a = get_config(ARCH, smoke=True, moe_impl="a2a")
    assert a2a.moe_impl == "a2a"
    assert get_config(ARCH, smoke=True).moe_impl == "grouped"


def test_moe_keeps_the_expert_layout_and_init():
    """(E, d, f) experts drawn with std 1/sqrt(E), as `repro`'s dense_init
    reads the leading dim as the fan-in; the router (d, E) in fp32."""
    cfg = get_config(ARCH, smoke=True)
    moe = init_params(torch.Generator().manual_seed(0), cfg).blocks[0].ffn
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert tuple(moe.w_gate.shape) == (E, d, f) and moe.w_gate.dtype == cfg.dtype
    assert tuple(moe.w_down.shape) == (E, f, d)
    assert tuple(moe.router.shape) == (d, E) and moe.router.dtype == torch.float32
    assert float(moe.w_up.float().abs().max()) <= 2 / np.sqrt(E) + 1e-6
    assert float(moe.router.abs().max()) <= 2 / np.sqrt(d) + 1e-6


# --------------------------------------------------------------- the model

@pytest.mark.parametrize("impl", ["grouped", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_logits_and_loss_match_jax(dtype, impl):
    """Train logits, and `loss_fn`'s loss (ce + moe_aux_weight * aux), ce and
    aux: fp32 elementwise; bf16 logits by relative norm."""
    jcfg, jparams, cfg, model = carry(dtype, moe_impl=impl)
    batch = {"tokens": tokens(cfg, 2, 24, seed=2)}
    want, jaux = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(
        batch["tokens"])}, mode="train")
    got, aux = forward(model, cfg, {"tokens": torch.from_numpy(
        batch["tokens"])}, mode="train")
    close(got, want, dtype)
    assert float(aux) == pytest.approx(float(jaux), rel=LOSS_TOL[dtype])
    jloss, (jce, jaux) = JS.loss_fn(jparams, jcfg, batch)
    loss, (ce, aux) = loss_fn(model, cfg, batch)
    for g, w in ((loss, jloss), (ce, jce), (aux, jaux)):
        assert float(g) == pytest.approx(float(w), rel=LOSS_TOL[dtype])
    assert float(aux) > 0 and float(loss) == pytest.approx(
        float(ce) + cfg.moe_aux_weight * float(aux), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    jcfg, jparams, cfg, model = carry(dtype)
    toks = tokens(cfg, 2, 19, seed=3)
    want, jcache, jaux = jax_forward(jparams, jcfg,
                                     {"tokens": jnp.asarray(toks)},
                                     mode="prefill")
    got, cache, aux = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                              mode="prefill")
    assert set(cache[0]) == set(jcache[0]) == {"k", "v"}
    assert float(aux) == pytest.approx(float(jaux), rel=LOSS_TOL[dtype])
    close(got, want, dtype, "logits")
    for name, leaf in cache[0].items():
        assert tuple(leaf.shape) == jcache[0][name].shape
        close(leaf, jcache[0][name], dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(dtype):
    """12 decode steps at ragged per-row positions: logits and caches (fp32
    elementwise, bf16 by relative norm)."""
    jcfg, jparams, cfg, model = carry(dtype)
    B, cap, steps = 3, 32, 12
    start = np.array([0, 3, 7])
    jdecode = jax.jit(lambda p, c, t, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", cache=c, pos=pos))
    jcache = jax_init_cache(jcfg, B, cap)
    cache = init_cache(cfg, B, cap, device="cpu")
    rng = np.random.default_rng(4)
    for i in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(start + i, jnp.int32))
        logits, _ = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                            mode="decode", cache=cache,
                            pos=torch.tensor(start + i))
        close(logits, jlogits, dtype, f"step {i}")
    for name in ("k", "v"):
        close(cache[0][name], jcache[0][name], dtype, name)


def test_greedy_generate_matches_jax():
    jcfg, jparams, cfg, model = carry()
    toks = tokens(cfg, 2, 20, seed=5)
    want = JS.greedy_generate(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              10)
    got = greedy_generate(cfg, model, {"tokens": torch.from_numpy(toks)}, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def ragged(make, vocab, n=7, seed=6):
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(0, vocab, int(rng.integers(2, 11))).astype(
        np.int32), max_new_tokens=int(rng.integers(2, 8))) for i in range(n)]


def test_engine_serves_granite_like_jax():
    """Seven ragged requests through three slots (slots freed and reused):
    the same tokens and steps as `repro`'s engine."""
    jcfg, jparams, cfg, model = carry()
    jreqs = ragged(JaxServeRequest, cfg.vocab_size)
    reqs = ragged(ServeRequest, cfg.vocab_size)
    jeng = JaxServingEngine(jcfg, jparams,
                            JaxEngineConfig(num_slots=3, kv_capacity=32))
    eng = ServingEngine(cfg, model, EngineConfig(num_slots=3, kv_capacity=32))
    for e, rs in ((jeng, jreqs), (eng, reqs)):
        for r in rs:
            e.submit(r)
        e.drain()
    assert eng.steps == jeng.steps
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert all(len(r.output) == r.max_new_tokens for r in reqs)


def test_serve_run_serves_granite_on_cpu():
    out = serve.run(ARCH, smoke=True, device="cpu", requests=20)
    ref = jax_serve_run(ARCH, smoke=True, requests=20)
    assert set(out) == set(ref) | {"decode_steps"}
    assert out["served"] == ref["served"] == 20
    assert out["offline_steps"] == 0 and out["decode_steps"] >= 6


def test_serve_share_trains_granite_beside_decode():
    """`--share` packs AdamW steps of granite (loss with the MoE aux) beside
    its decode steps, here and in `repro`, under conditions the host's load
    cannot decide."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = serve.run(ARCH, smoke=True, device="cpu", share=True,
                        requests=20, qps=SHARE_QPS, slo=LOOSE_SLO)
    finally:
        torch.set_num_threads(n)
    ref = jax_serve_run(ARCH, smoke=True, share=True, requests=20,
                        qps=SHARE_QPS, slo=LOOSE_SLO)
    for o in (out, ref):
        assert o["served"] >= 1 and o["offline_steps"] >= 1
        assert o["train_steps_done"] == o["offline_steps"] + 2


def test_loss_decreases_in_short_training_like_jax():
    """tests/test_models.py:137-141 (granite, 25 steps at B4 x 32), both
    launchers on the same arguments."""
    kw = dict(smoke=True, steps=25, batch=4, seq=32, lr=5e-3)
    out = train.run(ARCH, device="cpu", **kw)
    ref = jax_train_run(ARCH, **kw)
    for o in (out, ref):
        assert o["steps_done"] == 25 and not o["interrupted"]
        assert o["losses"][-1] < o["losses"][0] * 0.8


def test_train_step_reports_moe_aux():
    from repro_torch.models import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    _, _, cfg, _ = carry()
    model = init_params(torch.Generator().manual_seed(0), cfg)
    opt = AdamW(AdamWConfig(lr=1e-3, total_steps=10))
    state = opt.init(model.parameters())
    _, _, metrics = make_train_step(cfg, opt)(
        model, state, {"tokens": tokens(cfg, 2, 16)})
    aux = metrics["moe_aux"]
    assert not aux.requires_grad and float(aux) > 0
    assert float(metrics["loss"]) == pytest.approx(
        float(metrics["ce"]) + cfg.moe_aux_weight * float(aux), rel=1e-6)


# ------------------------------------------------------------------ params

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", sorted(PORTED))
def test_param_counts_match_repro(arch, smoke):
    port, ref = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                             smoke=smoke)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def test_full_param_counts():
    counts = {a: (get_config(a).param_count(),
                  get_config(a).active_param_count())
              for a in ("pixtral-12b", "seamless-m4t-medium", ARCH)}
    assert round(counts["pixtral-12b"][0] / 1e9, 3) == 12.248
    assert round(counts["seamless-m4t-medium"][0] / 1e9, 3) == 0.978
    assert [round(c / 1e9, 3) for c in counts[ARCH]] == [1.385, 0.480]
