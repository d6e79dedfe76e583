"""The port's Mamba and jamba-1.5-large-398b against the JAX package at
SMOKE: the config and the registry, the Mamba mixer (its scan from a given
state, the sequential oracle, the one-token decode), its init, then the
hybrid model at 8 and 16 layers (one and two repeats of the 8-position
super-block, so that a mix-up of position and repeat shows): train logits
and gradients, prefill logits and every cache leaf, decode at ragged
positions, bf16, stale state on slot reuse (F5), and the launchers;
weights carried across through numpy.  Greedy generation, AdamW steps and
the engine against `repro`'s are in tests/test_torch_jamba_steps.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.launch.serve import run as jax_serve_run
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as JSSM
from repro.models import steps as JS
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeRequest as JaxServeRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import (forward, greedy_generate, init_cache,
                                init_params, loss_fn)
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_jax
from repro_torch.models.steps import _copy_prefix_cache
from repro_torch.serving.engine import EngineConfig, ServeRequest, ServingEngine
from test_torch_mla import close, f32, normal, routes, tokens

ARCH = "jamba-1.5-large-398b"
P = 8                            # positions of the super-block
LAYERS = [8, 16]                 # one and two repeats
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@functools.cache
def carry(dtype: str = "float32", layers: int = 8):
    """(jcfg, jparams, cfg, model): `repro`'s SMOKE model at `layers`
    layers from PRNGKey(0) and the port's holding the same weights, on the
    CPU."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=getattr(jnp, dtype), num_layers=layers)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(ARCH, smoke=True, dtype=getattr(torch, dtype),
                     num_layers=layers)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def mamba0(jparams, model):
    """Layer 0's Mamba mixer in both packages."""
    return (jax.tree.map(lambda a: a[0], jparams["blocks"][0])["mixer"],
            model.blocks[0].mixer)


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("smoke", [True, False])
def test_config_copied_as_data(smoke):
    port, ref = get_config(ARCH, smoke=smoke), jax_get_config(ARCH,
                                                             smoke=smoke)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.pattern == ref.pattern and len(port.pattern) == P
    assert port.repeats == (1 if smoke else 9)


def test_full_param_counts():
    """FULL, and the five-layer cut the card runs at full width (its
    pattern's first five positions: four Mamba layers, two of them MoE,
    then attention), equal `repro`'s."""
    cfg, ref = get_config(ARCH), jax_get_config(ARCH)
    assert cfg.param_count() == ref.param_count() == 398_555_111_424
    assert cfg.active_param_count() == ref.active_param_count()
    cut = dataclasses.replace(cfg, num_layers=5, pattern=cfg.pattern[:5])
    jcut = dataclasses.replace(ref, num_layers=5, pattern=ref.pattern[:5])
    assert cut.param_count() == jcut.param_count() == 24_045_707_264
    assert cut.active_param_count() == jcut.active_param_count()


@pytest.mark.parametrize("smoke", [True, False])
def test_all_configs_match_repros(smoke):
    """`all_configs` holds all ten ids in `repro`'s order, each with
    `repro`'s parameter counts."""
    port, ref = all_configs(smoke=smoke), jax_all_configs(smoke=smoke)
    assert list(port) == list(ref) == ARCH_IDS
    for arch, cfg in port.items():
        assert cfg.name == ref[arch].name
        assert cfg.param_count() == ref[arch].param_count(), arch
        assert cfg.active_param_count() == ref[arch].active_param_count()


@pytest.mark.parametrize("pattern", [
    (("mamba", "dense"),),
    (("mamba", "moe"), ("attn", "dense")),
    (("attn", "dense"), ("attn", "moe")),
])
def test_hybrid_patterns_are_admitted(pattern):
    cfg = get_config(ARCH, smoke=True, pattern=pattern,
                     num_layers=2 * len(pattern))
    assert cfg.repeats == 2


@pytest.mark.parametrize("change", [
    dict(pattern=(("mamba", "none"),), num_layers=2),
    dict(pattern=(("mamba", "dense"), ("attn_cross", "dense")), num_layers=2),
    dict(pattern=(("mamba", "dense"), ("mlstm", "none")), num_layers=2),
    dict(pattern=(), num_layers=2),
])
def test_other_mixtures_raise_naming_the_roadmap(change):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_config(ARCH, smoke=True, **change)


def test_layers_must_fill_whole_super_blocks():
    with pytest.raises(ValueError, match="whole number"):
        get_config(ARCH, smoke=True, num_layers=12)


# ------------------------------------------------------- weights and init

def test_params_from_jax_puts_position_i_of_repeat_r_at_layer_r_P_plus_i():
    jcfg, jparams, cfg, model = carry(layers=16)
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            continue
        r, i = divmod(int(parts[1]), P)
        leaf = jparams["blocks"][i]
        for key in parts[2:]:
            leaf = leaf[key]
        np.testing.assert_array_equal(p.numpy(), np.asarray(leaf[r]),
                                      err_msg=name)
    mixer = model.blocks[9].mixer
    di, N, dtr = cfg.ssm_d_inner, cfg.ssm_state_dim, cfg.ssm_dt_rank
    assert {n: tuple(p.shape) for n, p in mixer.named_parameters()} == {
        "in_proj": (64, 2 * di), "conv_w": (4, di), "conv_b": (di,),
        "x_proj": (di, dtr + 2 * N), "dt_proj": (dtr, di), "dt_bias": (di,),
        "A_log": (di, N), "D": (di,), "out_proj": (di, 64)}
    assert [type(b.ffn).__name__ for b in model.blocks[:P]] == [
        "FFN", "MoE"] * 4
    assert [hasattr(b, "mixer") for b in model.blocks[:P]] == [
        True] * 4 + [False] + [True] * 3


def test_init_constants_are_mamba_inits():
    """A_log, D, dt_bias and the conv bias are `mamba_init`'s values; the
    projections draw with the fan-in rule."""
    jcfg, jparams, cfg, _ = carry()
    mixer = init_params(torch.Generator().manual_seed(0), cfg).blocks[0].mixer
    jmixer, _ = mamba0(jparams, carry()[3])
    for leaf in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(f32(getattr(mixer, leaf)),
                                   np.asarray(jmixer[leaf]), rtol=1e-7,
                                   atol=0, err_msg=leaf)
    for leaf in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        w = getattr(mixer, leaf).float()
        assert float(w.abs().max()) <= 2 / np.sqrt(w.shape[0]) + 1e-6, leaf


def test_init_scales_are_keyed_by_module():
    """Mamba's conv taps draw at 1/sqrt(dc) and the mLSTM's at 0.5: at dc 16
    one is 0.25 and the other 0.5, though both leaves are `conv_w`."""
    mamba = init_params(torch.Generator().manual_seed(0), get_config(
        ARCH, smoke=True, ssm_conv_dim=16)).blocks[0].mixer.conv_w.float()
    mlstm = init_params(torch.Generator().manual_seed(0), get_config(
        "xlstm-350m", smoke=True, ssm_conv_dim=16)).blocks[0].mixer.conv_w
    assert float(mamba.abs().max()) <= 0.5 + 1e-6
    assert 0.8 * 0.25 < float(mamba.std()) < 0.25
    assert float(mlstm.float().abs().max()) > 0.5
    assert 0.8 * 0.5 < float(mlstm.float().std()) < 0.5


# ------------------------------------------------------------ the mixer

@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_mixer_matches_jax(with_h0):
    """y and h_last of the mixer (the scan through `ops.ssm_scan`) against
    `repro`'s chunked mixer, S 21 (its gcd fallback, chunks of 1), from
    zero or a random state; the oracle against `repro`'s."""
    jcfg, jparams, cfg, model = carry()
    jmix, mix = mamba0(jparams, model)
    x = normal((2, 21, cfg.d_model), 1)
    h0 = normal((2, cfg.ssm_d_inner, cfg.ssm_state_dim), 2) if with_h0 \
        else None
    want, jh = JSSM.mamba_mixer(jmix, jnp.asarray(x), jcfg,
                                h0=None if h0 is None else jnp.asarray(h0))
    got, h = S.mamba_mixer(mix, torch.from_numpy(x), cfg,
                           h0=None if h0 is None else torch.from_numpy(h0))
    close(got, want, "float32", "y")
    close(h, jh, "float32", "h_last")
    if not with_h0:
        close(S.mamba_mixer_ref(mix, torch.from_numpy(x), cfg),
              JSSM.mamba_mixer_ref(jmix, jnp.asarray(x), jcfg), "float32",
              "ref")


def test_mamba_decode_steps_match_jax():
    """20 one-token steps from a prefill's state: each step's output and
    the final h and conv window against `repro`'s decode step."""
    jcfg, jparams, cfg, model = carry()
    jmix, mix = mamba0(jparams, model)
    x = normal((2, 6, cfg.d_model), 3)
    _, jh = JSSM.mamba_mixer(jmix, jnp.asarray(x), jcfg)
    jx_in = jnp.asarray(x) @ jmix["in_proj"][:, :cfg.ssm_d_inner]
    jst = {"h": jh, "conv": jx_in[:, -3:]}
    st = {k: torch.from_numpy(np.asarray(v)) for k, v in jst.items()}
    for i in range(20):
        xt = normal((2, 1, cfg.d_model), 10 + i)
        want, jst = JSSM.mamba_decode_step(jmix, jnp.asarray(xt), jst, jcfg)
        got, st = S.mamba_decode_step(mix, torch.from_numpy(xt), st, cfg)
        close(got, want, "float32", f"step {i}")
    for k in ("h", "conv"):
        close(st[k], jst[k], "float32", k)
    init = S.mamba_state_init(3, cfg, "cpu")
    want = JSSM.mamba_state_init(3, jcfg)
    for k in ("h", "conv"):
        assert tuple(init[k].shape) == want[k].shape and not init[k].any()
    assert init["h"].dtype == torch.float32 and init["conv"].dtype == cfg.dtype


def test_mamba_mixer_routes_its_scan(monkeypatch):
    """Outside autograd the scan is `ops.ssm_scan` (the kernel on the
    card); under autograd, the plain loop, whose gradient reaches A_log."""
    _, _, cfg, model = carry()
    mix = model.blocks[0].mixer
    calls = []
    scan = ops.ssm_scan

    def record(*args, **kw):
        calls.append(kw)
        return scan(*args, **kw)

    monkeypatch.setattr(ops, "ssm_scan", record)
    x = torch.from_numpy(normal((1, 5, cfg.d_model), 4))
    with torch.no_grad():
        S.mamba_mixer(mix, x, cfg)
    assert calls == [{"h0": None, "return_state": True}]
    mix.A_log.requires_grad_(True)
    try:
        y, h = S.mamba_mixer(mix, x, cfg)
        g, = torch.autograd.grad(y.sum() + h.sum(), mix.A_log)
    finally:
        mix.A_log.requires_grad_(False)
    assert len(calls) == 1 and bool(g.abs().sum() > 0)


# -------------------------------------------------------------- the model

@pytest.mark.parametrize("layers", LAYERS)
def test_train_logits_and_aux_match_jax(layers):
    jcfg, jparams, cfg, model = carry(layers=layers)
    toks = tokens(cfg, 2, 13, seed=2)
    want, jaux = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             mode="train")
    got, aux = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                       mode="train")
    assert tuple(got.shape) == (2, 13, cfg.padded_vocab)
    close(got, want, "float32", "logits")
    assert float(aux) == pytest.approx(float(jaux), rel=1e-4)


def test_train_gradients_match_jax():
    """Every weight's gradient (fp32, 8 layers: Mamba through the plain
    scan under autograd) against `jax.grad` of `repro`'s loss_fn: within
    1e-4 of each leaf's largest."""
    jcfg, jparams, cfg, model = carry()
    batch = {"tokens": tokens(cfg, 2, 12, seed=4)}
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
    for (name, _), g in zip(weights.items(), grads):
        parts = name.split(".")
        if parts[0] == "blocks":
            r, i = divmod(int(parts[1]), P)
            leaf = jgrads["blocks"][i]
            for key in parts[2:]:
                leaf = leaf[key]
            want = np.asarray(leaf[r])
        else:
            want = np.asarray(jgrads[parts[0]] if len(parts) == 1
                              else jgrads[parts[0]][parts[1]])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("layers", LAYERS)
def test_prefill_matches_jax(layers):
    """Last-token logits and every cache leaf of every position: h (R, B,
    di, N) from the scan, the conv window (R, B, dc-1, di), k and v."""
    jcfg, jparams, cfg, model = carry(layers=layers)
    toks = tokens(cfg, 2, 19, seed=7)
    want, jcache, jaux = jax_forward(jparams, jcfg,
                                     {"tokens": jnp.asarray(toks)},
                                     mode="prefill")
    with torch.no_grad():
        got, cache, aux = forward(model, cfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  mode="prefill")
    close(got, want, "float32", "logits")
    assert float(aux) == pytest.approx(float(jaux), rel=1e-4)
    assert len(cache) == len(jcache) == P
    for i, (c, jc) in enumerate(zip(cache, jcache)):
        assert set(c) == set(jc) == ({"k", "v"} if i == 4 else
                                     {"h", "conv"})
        for name, leaf in c.items():
            assert tuple(leaf.shape) == jc[name].shape, (i, name)
            close(leaf, jc[name], "float32", f"{i}.{name}")


@pytest.mark.parametrize("layers", LAYERS)
def test_cache_layout_matches_jax(layers):
    jcfg, _, cfg, _ = carry(layers=layers)
    want = jax_init_cache(jcfg, 3, 40)
    got = init_cache(cfg, 3, 40, device="cpu")
    for c, jc in zip(got, want):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                for k, v in c.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in jc.items()}
        assert not any(v.any() for v in c.values())


@pytest.mark.parametrize("layers", LAYERS)
def test_decode_at_ragged_positions_matches_jax(layers):
    """20 decode steps at ragged per-row positions from a fresh cache:
    logits each step, then every cache leaf."""
    jcfg, jparams, cfg, model = carry(layers=layers)
    B, cap, steps = 3, 32, 20
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
        close(logits, jlogits, "float32", f"step {i}")
    for i, (c, jc) in enumerate(zip(cache, jcache)):
        for name, leaf in c.items():
            close(leaf, jc[name], "float32", f"{i}.{name}")


def serve(make_req, eng, prompts, new):
    reqs = [make_req(i, p.astype(np.int32), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]
    for r in reqs:
        eng.submit(r)
    eng.drain()
    return eng, [r.output for r in reqs]


def test_engine_keeps_stale_mamba_state_on_slot_reuse():
    """F5 for Mamba: one slot, two requests.  The first matches
    `greedy_generate`; the second starts from the h and conv window the
    first left and does not, in the port as in `repro`."""
    jcfg, jparams, cfg, model = carry()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 5) for _ in range(2)]
    alone = [greedy_generate(cfg, model, {"tokens": torch.from_numpy(
        p)[None]}, 5)[0].tolist() for p in prompts]
    _, want = serve(JaxServeRequest, JaxServingEngine(
        jcfg, jparams, JaxEngineConfig(num_slots=1, kv_capacity=32)),
        prompts, [6, 6])
    _, got = serve(ServeRequest, ServingEngine(
        cfg, model, EngineConfig(num_slots=1, kv_capacity=32)),
        prompts, [6, 6])
    assert got == want
    assert got[0] == alone[0] and got[1] != alone[1]


def test_serve_run_serves_jamba_on_cpu():
    """`serve.run` in both packages, under conditions the host's load
    cannot decide (tests/test_torch_generate.py: LOOSE_SLO, SHARE_QPS,
    one_torch_thread)."""
    from test_torch_generate import LOOSE_SLO, SHARE_QPS, one_torch_thread
    kw = dict(smoke=True, requests=20, qps=SHARE_QPS, slo=LOOSE_SLO)
    with one_torch_thread():
        out = serve_launch.run(ARCH, device="cpu", **kw)
    ref = jax_serve_run(ARCH, **kw)
    assert set(out) == set(ref) | {"decode_steps"}
    assert out["served"] == ref["served"] == 20
    assert out["offline_steps"] == 0 and out["decode_steps"] >= 6


def test_loss_decreases_in_short_training():
    """tests/test_models.py:137-141's run (25 AdamW steps at B4 x 32)
    through the port's launcher (each step is held against `repro`'s in
    tests/test_torch_jamba_steps.py).  On one intra-op thread
    (tests/test_torch_generate.py's one_torch_thread): the plain scan's
    many small ops under autograd, on a thread a core beside the other
    test workers, took 277 s where they take 10 alone."""
    from test_torch_generate import one_torch_thread
    with one_torch_thread():
        out = train_launch.run(ARCH, device="cpu", smoke=True, steps=25,
                               batch=4, seq=32, lr=5e-3)
    assert out["steps_done"] == 25 and not out["interrupted"]
    assert out["losses"][-1] < out["losses"][0] * 0.8


# bf16.  `repro`'s forward runs its blocks under `lax.scan`, which XLA
# compiles as one program and in which it keeps some bf16 intermediates in
# fp32; op by op (each block through `repro`'s own `_apply_block`, the head
# in eager JAX) every result is rounded to bf16, as the port's are.  A
# jamba SMOKE decode step's logits from `repro`'s compiled forward are
# 1.9 % by relative norm from the same step op by op, with every layer's
# output equal: the 2e-2 limit is at the compilation's own noise there.  So
# the decode steps are held against `repro` op by op, and the prefill
# logits against its forward.  bf16 top-k routing is discontinuous
# (tests/test_torch_mla.py): the prefill prompt is the first of seeds 0-39
# at B2 x 19 on which both packages route every token alike, and the test
# checks that they do.
BF16_SEED = 39


def jax_decode_op_by_op(jparams, jcfg, toks, cache, pos: int):
    """`repro`'s decode step evaluated op by op: `model._apply_block` for
    each layer r * P + i on repeat r of cache[i], then the final norm and
    the head.  Returns (logits, new cache)."""
    from repro.models import layers as JL
    from repro.models import model as JM
    x = jnp.take(jparams["embed"], toks, axis=0) * float(
        np.sqrt(jcfg.d_model))
    positions = jnp.full((toks.shape[0], 1), pos)
    new = [[] for _ in jcfg.pattern]
    for r in range(jcfg.repeats):
        for i, desc in enumerate(jcfg.pattern):
            x, nc, _ = JM._apply_block(
                jax.tree.map(lambda a: a[r], jparams["blocks"][i]), x, jcfg,
                desc, positions, jax.tree.map(lambda a: a[r], cache[i]),
                "decode")
            new[i].append(nc)
    logits = JL.rmsnorm(jparams["final_norm"], x)[:, 0] @ jparams["lm_head"]
    return logits, tuple(jax.tree.map(lambda *a: jnp.stack(a), *nc)
                         for nc in new)


def test_bf16_prefill_and_decode_match_jax(monkeypatch):
    """bf16, 8 layers: the prefill logits against `repro`'s forward, then 8
    decode steps from its cache against `repro`'s decode step op by op,
    each within 2e-2 by relative norm, on a prompt both packages route
    alike.  (At 16 layers, eight MoE layers, none of the first 80 prompts
    at B2 or B1 x 19 routes alike.)"""
    jcfg, jparams, cfg, model = carry("bfloat16")
    toks = tokens(cfg, 2, 19, seed=BF16_SEED)
    with routes(monkeypatch) as (port, ref):
        want, jcache, _ = jax_forward(jparams, jcfg,
                                      {"tokens": jnp.asarray(toks)},
                                      mode="prefill")
        with torch.no_grad():
            got, cache, _ = forward(model, cfg,
                                    {"tokens": torch.from_numpy(toks)},
                                    mode="prefill")
        jax.effects_barrier()
    assert len(port) == len(ref) == cfg.num_layers // 2
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
    close(got, want, "bfloat16", "prefill logits")
    B, S0, steps = 2, 19, 8
    jd = JS._copy_prefix_cache(jcfg, jcache, jax_init_cache(jcfg, B,
                                                            S0 + steps))
    dcache = _copy_prefix_cache(cache, init_cache(cfg, B, S0 + steps,
                                                  device="cpu"))
    rng = np.random.default_rng(9)
    for i in range(steps):
        t = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jd = jax_decode_op_by_op(jparams, jcfg, jnp.asarray(t), jd,
                                     S0 + i)
        with torch.no_grad():
            gl, _ = forward(model, cfg, {"tokens": torch.from_numpy(t)},
                            mode="decode", cache=dcache, pos=S0 + i)
        close(gl, jl, "bfloat16", f"decode step {i}")
