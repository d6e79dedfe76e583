"""The port's h2o-danube-3-4b and gemma-7b against the JAX model: the configs
copied as data, the GELU gate and the GELU FFN, the weights carried across,
and the train and decode logits at SMOKE (prefill: test_torch_generate.py)."""
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
from repro_torch.configs import get_config
from repro_torch.models import forward, init_cache
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax

ARCHS = ["h2o-danube-3-4b", "gemma-7b"]
# the reference's limits (tests/test_kernels.py:12)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def carry(arch: str, dtype: str = "float32"):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=getattr(jnp, dtype))
    cfg = get_config(arch, smoke=True, dtype=getattr(torch, dtype))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copied_as_data(arch, smoke):
    port, ref = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.param_count() == ref.param_count()
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_parameter(arch):
    """`params_from_jax` needs no change for these configs: every leaf
    lands unchanged, and the counts agree."""
    jcfg, jparams, _, model = carry(arch)
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()
    blocks = jparams["blocks"][0]
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            leaf = blocks[parts[2]][parts[3]][int(parts[1])]
        else:
            leaf = jparams[parts[0]] if len(parts) == 1 \
                else jparams[parts[0]][parts[1]]
        np.testing.assert_array_equal(p.numpy(), np.asarray(leaf),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    """Op by op in the input type, as `jax.nn.gelu(approximate=True)`."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 4
    want = jax.nn.gelu(jnp.asarray(x, getattr(jnp, dtype)), approximate=True)
    got = L.gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_ffn_matches_jax(dtype):
    """gemma-7b SMOKE's block-0 FFN on the same input."""
    _, jparams, cfg, model = carry("gemma-7b", dtype)
    jffn = jax.tree.map(lambda a: a[0], jparams["blocks"][0])["ffn"]
    x = np.random.default_rng(1).standard_normal((2, 8, cfg.d_model),
                                                 np.float32)
    want = JL.ffn(jffn, jnp.asarray(x, getattr(jnp, dtype)), "gelu")
    got = L.ffn(model.blocks[0].ffn, torch.from_numpy(x).to(cfg.dtype),
                cfg.ffn_act)
    assert cfg.ffn_act == "gelu" and got.dtype == cfg.dtype
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_jax(arch):
    jcfg, jparams, cfg, model = carry(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24))
    want, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                          mode="train")
    got, _ = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                     mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_jax(arch):
    """24 decode steps at ragged per-row positions from a capacity-64 cache
    (h2o-danube-3-4b's ring of 16 is run past): logits and caches."""
    jcfg, jparams, cfg, model = carry(arch)
    B, cap, steps = 3, 64, 24
    start = np.array([0, 4, 9])
    jdecode = jax.jit(lambda p, c, t, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", cache=c, pos=pos))
    jcache = jax_init_cache(jcfg, B, cap)
    cache = init_cache(cfg, B, cap, device="cpu")
    rng = np.random.default_rng(4)
    t = TOL["float32"]
    for i in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(start + i, jnp.int32))
        logits, _ = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                            mode="decode", cache=cache,
                            pos=torch.tensor(start + i))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=t, rtol=t, err_msg=f"step {i}")
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[0][name].numpy(),
                                   np.asarray(jcache[0][name]), atol=t,
                                   rtol=t)
