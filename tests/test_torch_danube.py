"""The port's h2o-danube-1.8b path against the JAX model: the config, the
materialised sliding-window attention, the dense train forward, its loss and
gradients, AdamW train steps (with and without gradient accumulation) and
the ring-cache decode, from weights carried across through numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models.steps import loss_fn as jax_loss_fn
from repro.models.steps import make_train_step as jax_train_step
from repro.optim.optimizer import AdamW as JaxAdamW
from repro.optim.optimizer import AdamWConfig as JaxAdamWConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import (forward, init_cache, loss_fn,
                                make_train_step)
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW, AdamWConfig

ARCH = "h2o-danube-1.8b"
# fp32: two frameworks' matmul and transcendental orders
# (tests/test_torch_models.py); bf16: the reference's bf16 limit
# (tests/test_kernels.py:12)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def carry(dtype: str):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=getattr(jnp, dtype))
    cfg = get_config(ARCH, smoke=True, dtype=getattr(torch, dtype))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def fp32():
    return carry("float32")


def jax_leaf(tree: dict, name: str):
    """`repro`'s leaf for the port's parameter `name`: blocks.<r>.a.b is
    tree["blocks"][0][a][b][r]."""
    parts = name.split(".")
    if parts[0] != "blocks":
        node = tree
        for p in parts:
            node = node[p]
        return node
    node = tree["blocks"][0]
    for p in parts[2:]:
        node = node[p]
    return node[int(parts[1])]


@pytest.mark.parametrize("smoke", [True, False])
def test_config_copied_as_data(smoke):
    port, ref = get_config(ARCH, smoke=smoke), jax_get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.param_count() == ref.param_count()
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


def test_full_width_parameter_count():
    assert get_config(ARCH).param_count() == 1_831_201_280


def test_carried_model_holds_every_parameter(fp32):
    jcfg, jparams, _, model = fp32
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.numpy(),
                                      np.asarray(jax_leaf(jparams, name)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, 7)])
def test_attention_matches_jax(dtype, causal, window):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 12, s, 16)).astype(np.float32)
               for s in (4, 2, 2))
    want = JL.attention(*(jnp.asarray(a, getattr(jnp, dtype))
                          for a in (q, k, v)), causal=causal, window=window)
    got = L.attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                        for a in (q, k, v)), causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_attention_past_the_materialise_limit_raises():
    """Past 4096**2 scores a head (with chunks that divide) the port no
    longer raises: it streams KV chunks as `repro` does, to `repro`'s
    result (with h2o-danube-1.8b's window of 4096)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 4096, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 8192, 1, 8)).astype(np.float32)
            for _ in range(2))
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, window=4096)
    got = L.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                      causal=False, window=4096)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_repeat_kv_matches_jax():
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        L.repeat_kv(torch.from_numpy(k), 3).numpy(),
        np.asarray(JL.repeat_kv(jnp.asarray(k), 3)))


def test_train_forward_matches_jax(fp32):
    """Batch 2, seq 32: past the window of 16, so the mask matters."""
    jcfg, jparams, cfg, model = fp32
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    want, jaux = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             mode="train")
    got, aux = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                       mode="train")
    assert tuple(got.shape) == (2, 32, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"],
                               rtol=TOL["float32"])
    assert float(aux) == float(jaux) == 0.0


def test_loss_and_gradients_match_jax(fp32):
    jcfg, jparams, cfg, model = fp32
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32))
    batch = {"tokens": toks.astype(np.int32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, batch), has_aux=True)(jparams)
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
        want = np.asarray(jax_leaf(jgrads, name))
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_train_steps_match_jax(dtype, microbatches):
    """Three AdamW steps from the same weights, batch 4 x 32 tokens: losses
    and gradient norms within 1e-4 relative in fp32, 2e-2 in bf16."""
    jcfg, jparams, cfg, model = carry(dtype)
    acfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jopt = JaxAdamW(JaxAdamWConfig(**acfg))
    jstate = jopt.init(jparams)
    jstep = jax.jit(jax_train_step(jcfg, jopt, microbatches=microbatches))
    opt = AdamW(AdamWConfig(**acfg))
    state = opt.init(model.parameters())
    step = make_train_step(cfg, opt, microbatches=microbatches)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 4, seed=41))
    for i in range(3):
        batch = pipe.batch_at(i)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        model, state, m = step(model, state, batch)
        for key in ("loss", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm[key]),
                                                  rel=TOL[dtype]), (i, key)
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("ragged", [False, True])
def test_ring_decode_matches_jax(fp32, ragged):
    """kv_cap 64 gives a ring of 16 (the window); 40 steps run every
    position past it, per-row positions included."""
    jcfg, jparams, cfg, model = fp32
    B, cap, steps = 3, 64, 40
    start = np.array([0, 5, 11]) if ragged else np.zeros(B, np.int64)
    jdecode = jax.jit(lambda p, c, t, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", cache=c, pos=pos))
    jcache = jax_init_cache(jcfg, B, cap)
    cache = init_cache(cfg, B, cap, device="cpu")
    assert cache[0]["k"].shape[2] == jcache[0]["k"].shape[2] == cfg.window
    rng = np.random.default_rng(0)
    for i in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        if ragged:
            jpos, pos = jnp.asarray(start + i, jnp.int32), torch.tensor(start + i)
        else:
            jpos, pos = jnp.int32(i), i
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(toks), jpos)
        logits, _ = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                            mode="decode", cache=cache, pos=pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=TOL["float32"], rtol=TOL["float32"],
                                   err_msg=f"step {i}")
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[0][name].numpy(),
                                       np.asarray(jcache[0][name]),
                                       atol=TOL["float32"],
                                       rtol=TOL["float32"])


def test_short_cache_is_no_ring(fp32):
    """Below the window the cache keeps its capacity and a position at the
    capacity raises, as for a full-attention model."""
    _, _, cfg, model = fp32
    cache = init_cache(cfg, 2, 8, device="cpu")
    assert cache[0]["k"].shape[2] == 8
    with pytest.raises(ValueError, match="kv_len"):
        forward(model, cfg, {"tokens": torch.zeros(2, 1, dtype=torch.long)},
                mode="decode", cache=cache, pos=8)
