"""The port's mistral-nemo-12b decode path against the JAX model: SMOKE
config in fp32, JAX weights carried across through numpy."""
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
from repro_torch.configs import get_config
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models.convert import params_from_jax

ARCH = "mistral-nemo-12b"
TOL = 1e-4     # fp32, two frameworks' matmul and transcendental orders


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=jnp.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(ARCH, smoke=True, dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


@pytest.mark.parametrize("smoke", [True, False])
def test_config_copied_as_data(smoke):
    port = get_config(ARCH, smoke=smoke)
    ref = jax_get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert port.padded_vocab == ref.padded_vocab


def test_param_count_matches_reference(setup):
    jcfg, _, _, model = setup
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()


def test_init_params_draws_like_reference():
    """Same distributions as repro's init (the draws themselves differ)."""
    cfg = get_config(ARCH, smoke=True, dtype=torch.float32)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.05)
    w = model.blocks[0].ffn.w_gate
    std = 1 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 2 * std
    assert torch.equal(model.blocks[1].norm2.scale, torch.ones(cfg.d_model))


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_matches_jax(setup, ragged):
    jcfg, jparams, cfg, model = setup
    B, cap, steps = 3, 32, 4
    start = np.array([0, 5, 11]) if ragged else np.zeros(B, np.int64)
    jdecode = jax.jit(lambda p, c, t, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", cache=c, pos=pos))
    jcache = jax_init_cache(jcfg, B, cap)
    cache = init_cache(cfg, B, cap, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        if ragged:
            jpos, pos = jnp.asarray(start + i, jnp.int32), torch.tensor(start + i)
        else:
            jpos, pos = jnp.int32(i), i
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(toks), jpos)
        logits, out_cache = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                                    mode="decode", cache=cache, pos=pos)
        assert out_cache is cache                       # updated in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[0][name].numpy(),
                                       np.asarray(jcache[0][name]),
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("device,pos", [
    ("cpu", 8),
    ("cpu", [3, 8]),
    pytest.param("cuda", [3, 8], marks=pytest.mark.cuda),
])
def test_position_past_the_cache_raises(device, pos):
    """A position at the capacity raises, wherever pos lives: the kernel
    would clamp it and overwrite the last cache row."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_config(ARCH, smoke=True, dtype=torch.float32)
    model = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    cache = init_cache(cfg, 2, 8, device=device)
    with pytest.raises(ValueError, match="kv_len"):
        forward(model, cfg, {"tokens": torch.zeros(2, 1, dtype=torch.long)},
                mode="decode", cache=cache, pos=torch.tensor(pos, device=device))


def test_only_decode_is_ported(setup):
    """Decode, prefill, train and (since the fused loss) `repro`'s
    `train_hidden` are ported for the dense pattern; a mode `repro` does
    not have is refused."""
    _, _, cfg, model = setup
    logits, cache, _ = forward(
        model, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
        mode="prefill")
    assert tuple(logits.shape) == (1, cfg.padded_vocab)
    assert cache[0]["k"].shape[2] == 4
    hidden, _ = forward(model, cfg,
                        {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                        mode="train_hidden")
    assert tuple(hidden.shape) == (1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward(model, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                mode="sample")


# ReLU (seamless-m4t-medium), the MoE pattern (granite-moe-1b-a400m),
# jamba's Mamba and hybrid super-blocks and the all-to-all MoE dispatch are
# ported now: MLA beside Mamba and an mLSTM position mixed with attention
# take their places
@pytest.mark.parametrize("change", [{"pattern": (("mamba", "dense"),),
                                     "attn_kind": "mla"},
                                    {"pattern": (("attn", "dense"),
                                                 ("mlstm", "none"))}])
def test_unported_model_variants_raise(change):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(ARCH, smoke=True, **change)


def test_a2a_without_a_mesh_is_the_grouped_dispatch():
    """moe_impl="a2a" with no mesh installed: the whole model's train
    logits and aux are the grouped dispatch's, bit for bit (`repro`'s
    fallback, moe.py:160-162)."""
    import dataclasses
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              dtype=torch.float32)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8),
                                     generator=torch.Generator().manual_seed(1))}
    want, want_aux = forward(model, cfg, batch, mode="train")
    a2a = dataclasses.replace(cfg, moe_impl="a2a")
    got, aux = forward(model, a2a, batch, mode="train")
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
