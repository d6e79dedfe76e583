"""The port's MLA (multi-head latent attention) and deepseek-v2-lite-16b
against the JAX package at SMOKE: the config, the latent and the attention
of `repro`'s `mla_latent` and `mla_attend`, the route the kernels take (v
zero-padded to the q.k width, the output cut back) against `repro`'s
materialised attention at a v width apart from q's, then the model in every
mode (train logits, loss and gradients, prefill logits and the latent cache,
decode at ragged positions, greedy generation, the serving engine under
slot reuse, `serve.run` and the training launcher) and the parameter counts
at FULL; weights carried across through numpy."""
import contextlib
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
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import steps as JS
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeRequest as JaxServeRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import (forward, greedy_generate, init_cache,
                                init_params, loss_fn)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import ModelConfig
from repro_torch.serving.engine import EngineConfig, ServeRequest, ServingEngine

ARCH = "deepseek-v2-lite-16b"
# models: fp32 1e-4, bf16 2e-2 by relative norm; attention alone: the
# reference's fp32 limit (tests/test_kernels.py:12)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_TOL = 2e-5


@functools.cache
def carry(dtype: str = "float32"):
    """(jcfg, jparams, cfg, model): `repro`'s SMOKE model from PRNGKey(0)
    and the port's holding the same weights, on the CPU."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=getattr(jnp, dtype))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(ARCH, smoke=True, dtype=getattr(torch, dtype))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def close(got, want, dtype: str, what: str = "") -> None:
    """fp32 elementwise at 1e-4; bf16 by relative norm at 2e-2."""
    got, want = f32(got), f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=what)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= TOL[dtype], (what, rel)


def tokens(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def normal(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def layer0(jparams, model):
    """Block 0's MLA in both packages."""
    return (jax.tree.map(lambda a: a[0], jparams["blocks"][0])["attn"],
            model.blocks[0].attn)


@contextlib.contextmanager
def routes(monkeypatch):
    """Records the experts every MoE call routes each token to, in call
    order: yields (port's, repro's), lists of (B, S, K) arrays.  repro's
    router runs traced inside its layer scan, so its choices come back
    through a debug callback."""
    port, ref = [], []
    fn, jfn = M.router_probs, JM.router_probs

    def record(*args, **kw):
        w, idx, aux = fn(*args, **kw)
        port.append(idx.numpy())
        return w, idx, aux

    def jrecord(*args, **kw):
        w, idx, aux = jfn(*args, **kw)
        jax.debug.callback(lambda i: ref.append(np.asarray(i)), idx,
                           ordered=True)
        return w, idx, aux

    with monkeypatch.context() as m:
        m.setattr(M, "router_probs", record)
        m.setattr(JM, "router_probs", jrecord)
        yield port, ref


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("smoke", [True, False])
def test_config_copied_as_data(smoke):
    port, ref = get_config(ARCH, smoke=smoke), jax_get_config(ARCH,
                                                             smoke=smoke)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.attn_kind == "mla" and port.pattern == (("attn", "moe"),)
    if not smoke:
        assert (port.num_layers, port.d_model, port.num_heads,
                port.head_dim, port.kv_lora_rank, port.rope_head_dim,
                port.num_experts, port.top_k, port.num_shared_experts,
                port.moe_d_ff, port.vocab_size) == (
            27, 2048, 16, 128, 512, 64, 64, 6, 2, 1408, 102400)


def test_full_param_counts():
    cfg = get_config(ARCH)
    assert cfg.param_count() == 16_210_311_168
    assert cfg.active_param_count() == 2_663_233_536
    ref = jax_get_config(ARCH)
    assert (cfg.param_count(), cfg.active_param_count()) == (
        ref.param_count(), ref.active_param_count())


@pytest.mark.parametrize("change", [
    dict(attn_kind="absorbed"),
    dict(window=16),
    dict(pattern=(("attn_cross", "dense"),), enc_layers=2),
    dict(pattern=(("mlstm", "none"),)),
])
def test_unported_mla_variants_raise_naming_the_roadmap(change):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_config(ARCH, smoke=True, **change)
    assert isinstance(get_config(ARCH, smoke=True,
                                 pattern=(("attn", "dense"),)), ModelConfig)


def test_params_from_jax_loads_every_leaf():
    """The MLA leaves carry `repro`'s names and shapes, so the strict load
    needs no new mapping; the count is `repro`'s param_count."""
    jcfg, jparams, cfg, model = carry()
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()
    blocks = jparams["blocks"][0]
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            continue
        leaf = blocks[parts[2]]
        for key in parts[3:]:
            leaf = leaf[key]
        np.testing.assert_array_equal(p.numpy(), np.asarray(leaf[int(
            parts[1])]), err_msg=name)
    H, dh, r, dr = 4, 16, 32, 8
    attn = model.blocks[0].attn
    assert {n: tuple(p.shape) for n, p in attn.named_parameters()} == {
        "w_q": (64, H * (dh + dr)), "w_dkv": (64, r), "w_kr": (64, dr),
        "w_uk": (r, H * dh), "w_uv": (r, H * dh), "w_o": (H * dh, 64)}


def test_init_draws_with_the_fan_in_rule():
    """`dense_init`'s truncated normal, std 1/sqrt(fan_in), fan_in the
    leading dim, for every MLA leaf."""
    cfg = get_config(ARCH, smoke=True)
    attn = init_params(torch.Generator().manual_seed(0), cfg).blocks[0].attn
    for name, p in attn.named_parameters():
        bound = 2 / np.sqrt(p.shape[0]) + 1e-6
        assert float(p.float().abs().max()) <= bound, name
        assert float(p.float().std()) > 0.5 / np.sqrt(p.shape[0]), name


# ------------------------------------------------------------ MLA pieces

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_latent_matches_jax(dtype):
    jcfg, jparams, cfg, model = carry(dtype)
    jattn, attn = layer0(jparams, model)
    x = normal((2, 11, cfg.d_model), 1)
    pos = np.arange(3, 14)
    jc, jk = JL.mla_latent(jattn, jnp.asarray(x, jcfg.dtype), jcfg,
                           jnp.asarray(pos))
    rope = L.rope_table(torch.from_numpy(pos)[None], cfg.rope_head_dim,
                        cfg.rope_theta)
    c, k = L.mla_latent(attn, torch.from_numpy(x).to(cfg.dtype), cfg, rope)
    assert tuple(c.shape) == jc.shape == (2, 11, cfg.kv_lora_rank)
    assert tuple(k.shape) == jk.shape == (2, 11, 1, cfg.rope_head_dim)
    assert c.dtype == k.dtype == cfg.dtype
    # one projection and one rotation: both round alike in either type
    np.testing.assert_allclose(f32(c), f32(jc), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(f32(k), f32(jk), atol=2e-5 if dtype ==
                               "float32" else 1e-2, rtol=ATTN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_attend_matches_jax(dtype, causal):
    """Queries from x against latents of more positions (Sq != Skv when
    not causal), through `attention`: the output after w_o."""
    jcfg, jparams, cfg, model = carry(dtype)
    jattn, attn = layer0(jparams, model)
    Sq = 9 if causal else 3
    x = normal((2, Sq, cfg.d_model), 2)
    c_kv = normal((2, 9, cfg.kv_lora_rank), 3)
    k_rope = normal((2, 9, 1, cfg.rope_head_dim), 4)
    pos = np.arange(Sq) + (0 if causal else 6)
    want = JL.mla_attend(jattn, *(jnp.asarray(a, jcfg.dtype)
                                  for a in (x, c_kv, k_rope)),
                         jcfg, jnp.asarray(pos), causal=causal)
    rope = L.rope_table(torch.from_numpy(pos)[None], cfg.rope_head_dim,
                        cfg.rope_theta)
    got = L.mla_attend(attn, *(torch.from_numpy(a).to(cfg.dtype)
                               for a in (x, c_kv, k_rope)),
                       cfg, rope, causal=causal)
    assert tuple(got.shape) == (2, Sq, cfg.d_model) and got.dtype == cfg.dtype
    close(got, want, dtype)


# (q.k width, v width): SMOKE's 16 + 8 over 16, FULL's 128 + 64 over 128
WIDTHS = [(24, 16), (192, 128)]


@pytest.mark.parametrize("dq,dv", WIDTHS)
def test_padded_v_prefill_route_matches_repros_attention(dq, dv):
    """The flash kernel's entry point (its plain version here) on v
    zero-padded to q's width, cut back: `repro`'s materialised attention at
    the scale dq**-0.5.  Padding q or k, or scaling by the v width, fails
    here."""
    B, S, H = 2, 13, 3
    q, k = normal((B, S, H, dq), 5), normal((B, S, H, dq), 6)
    v = normal((B, S, H, dv), 7)
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True)
    got = L.pad_v(ops.flash_attention)(*map(torch.from_numpy, (q, k, v)),
                                       causal=True)
    assert tuple(got.shape) == (B, S, H, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("dq,dv", WIDTHS)
def test_padded_v_decode_route_matches_repros_attention(dq, dv):
    """The decode kernel's entry point on v zero-padded, at ragged cache
    lengths: `repro`'s decode attention (kv_len, not causal)."""
    B, Skv, H = 3, 20, 2
    q = normal((B, 1, H, dq), 8)
    k, v = normal((B, Skv, H, dq), 9), normal((B, Skv, H, dv), 10)
    lens = np.array([1, 7, 20])
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, kv_len=jnp.asarray(lens))
    got = L.pad_v(ops.decode_attention)(*map(torch.from_numpy, (q, k, v)),
                                        torch.from_numpy(lens))
    assert tuple(got.shape) == (B, 1, H, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def test_pad_v_passes_the_kernels_one_width():
    """What the kernel sees: q and k as given, v zero-padded to q's width,
    so the kernels' shape checks (k.shape == v.shape) hold."""
    seen = {}

    def kernel(q, k, v, **kw):
        seen.update(q=q, k=k, v=v, kw=kw)
        return torch.ones(q.shape[:-1] + (q.shape[-1],))

    q, k = torch.randn(1, 4, 2, 24), torch.randn(1, 4, 2, 24)
    v = torch.randn(1, 4, 2, 16)
    out = L.pad_v(kernel)(q, k, v, causal=True)
    assert seen["q"] is q and seen["k"] is k and seen["kw"] == {"causal": True}
    assert tuple(seen["v"].shape) == (1, 4, 2, 24)
    assert torch.equal(seen["v"][..., :16], v)
    assert not seen["v"][..., 16:].any()
    assert tuple(out.shape) == (1, 4, 2, 16)


# -------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_logits_and_loss_match_jax(dtype):
    jcfg, jparams, cfg, model = carry(dtype)
    batch = {"tokens": tokens(cfg, 2, 13, seed=2)}
    want, jaux = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(
        batch["tokens"])}, mode="train")
    got, aux = forward(model, cfg, {"tokens": torch.from_numpy(
        batch["tokens"])}, mode="train")
    assert tuple(got.shape) == (2, 13, cfg.padded_vocab)
    close(got, want, dtype, "logits")
    assert float(aux) == pytest.approx(float(jaux), rel=TOL[dtype])
    jloss, (jce, jaux) = JS.loss_fn(jparams, jcfg, batch)
    loss, (ce, aux) = loss_fn(model, cfg, batch)
    for g, w in ((loss, jloss), (ce, jce), (aux, jaux)):
        assert float(g) == pytest.approx(float(w), rel=TOL[dtype])


def test_train_gradients_match_jax():
    """One train step's gradients of every weight (fp32), against
    `jax.grad` of `repro`'s loss_fn: within 1e-4 of each leaf's largest."""
    jcfg, jparams, cfg, model = carry()
    batch = {"tokens": tokens(cfg, 2, 16, seed=4)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JS.loss_fn(p, jcfg, batch), has_aux=True)(jparams)
    weights = dict(model.named_parameters())
    for w in weights.values():
        w.requires_grad_(True)
    try:
        loss, _ = loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(weights.values()))
    finally:
        for w in weights.values():
            w.requires_grad_(False)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-4)
    blocks = jgrads["blocks"][0]
    for (name, _), g in zip(weights.items(), grads):
        parts = name.split(".")
        if parts[0] == "blocks":
            leaf = blocks[parts[2]]
            for key in parts[3:]:
                leaf = leaf[key]
            want = np.asarray(leaf[int(parts[1])])
        else:
            want = np.asarray(jgrads[parts[0]] if len(parts) == 1
                              else jgrads[parts[0]][parts[1]])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


# bf16 top-k routing is discontinuous: the packages' outputs differ by
# ulps (the prefill's attention is the kernel's fp32 softmax, F3 in
# ROADMAP.md), and an ulp in a router input can swap a token's second and
# third expert.  Most B2 x S19 prompts have one or two such tokens; where
# the swap reaches the last token (through its own route, or a slot it
# loses past an expert's capacity) its logits move by tens of percent
# (seeds 3, 9 and 11 of the first 12; seed 10 of 30 in
# granite-moe-1b-a400m).  So the prefill test uses a prompt on which the two
# packages route every token alike (seed 7; 8 is the other of the first
# 12), and checks that they do.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype, monkeypatch):
    """Last-token logits and every latent-cache leaf, ckv (R, B, S, r) and
    kr (R, B, S, 1, dr), for a prompt both packages route alike."""
    jcfg, jparams, cfg, model = carry(dtype)
    toks = tokens(cfg, 2, 19, seed=7)
    with routes(monkeypatch) as (port, ref):
        want, jcache, jaux = jax_forward(jparams, jcfg,
                                         {"tokens": jnp.asarray(toks)},
                                         mode="prefill")
        got, cache, aux = forward(model, cfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  mode="prefill")
        jax.effects_barrier()
    assert len(port) == len(ref) == cfg.num_layers
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
    assert set(cache[0]) == set(jcache[0]) == {"ckv", "kr"}
    assert tuple(cache[0]["ckv"].shape) == (2, 2, 19, cfg.kv_lora_rank)
    assert tuple(cache[0]["kr"].shape) == (2, 2, 19, 1, cfg.rope_head_dim)
    assert float(aux) == pytest.approx(float(jaux), rel=TOL[dtype])
    close(got, want, dtype, "logits")
    for name, leaf in cache[0].items():
        assert tuple(leaf.shape) == jcache[0][name].shape
        close(leaf, jcache[0][name], dtype, name)


def test_cache_layout_matches_jax():
    jcfg, _, cfg, _ = carry()
    want = jax_init_cache(jcfg, 3, 40)
    got = init_cache(cfg, 3, 40, device="cpu")
    assert {k: tuple(v.shape) for k, v in got[0].items()} == {
        k: v.shape for k, v in want[0].items()}
    assert all(v.dtype == cfg.dtype and not v.any() for v in got[0].values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(dtype):
    """12 decode steps at ragged per-row positions: logits and the latent
    caches (the rows each step writes, and the expansion of the live rows
    only)."""
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
    for name in ("ckv", "kr"):
        close(cache[0][name], jcache[0][name], dtype, name)


def test_decode_after_prefill_at_one_position_matches_jax():
    """greedy_generate's path: the prefill cache copied into a larger one,
    then decode at a scalar position."""
    jcfg, jparams, cfg, model = carry()
    toks = tokens(cfg, 2, 10, seed=5)
    want = JS.greedy_generate(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              8)
    got = greedy_generate(cfg, model, {"tokens": torch.from_numpy(toks)}, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_matches_jax():
    jcfg, jparams, cfg, model = carry()
    toks = tokens(cfg, 2, 20, seed=6)
    want = JS.greedy_generate(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              10)
    got = greedy_generate(cfg, model, {"tokens": torch.from_numpy(toks)}, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def ragged(make, vocab, n=7, seed=6):
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(0, vocab, int(rng.integers(2, 11))).astype(
        np.int32), max_new_tokens=int(rng.integers(2, 8))) for i in range(n)]


def test_engine_serves_deepseek_like_jax():
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


def test_serve_run_serves_deepseek_on_cpu():
    out = serve.run(ARCH, smoke=True, device="cpu", requests=20)
    ref = jax_serve_run(ARCH, smoke=True, requests=20)
    assert set(out) == set(ref) | {"decode_steps"}
    assert out["served"] == ref["served"] == 20
    assert out["offline_steps"] == 0 and out["decode_steps"] >= 6


def test_loss_decreases_in_short_training_like_jax():
    """tests/test_models.py:137-141's run (25 AdamW steps at B4 x 32),
    both launchers on the same arguments."""
    kw = dict(smoke=True, steps=25, batch=4, seq=32, lr=5e-3)
    out = train.run(ARCH, device="cpu", **kw)
    ref = jax_train_run(ARCH, **kw)
    for o in (out, ref):
        assert o["steps_done"] == 25 and not o["interrupted"]
        assert o["losses"][-1] < o["losses"][0] * 0.8
