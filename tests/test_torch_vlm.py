"""The port's pixtral-12b (the mistral-nemo-12b backbone behind a patch
frontend) against the JAX package at SMOKE: the config copied as data, the
weights carried across, the patch embeddings before the tokens and scaled
with them, the train logits and the loss with the patch positions cut out,
prefill and its cache, decode after a prefill, greedy generation (the
cache sized past the patches), the eval step, the serve entry point, and
the serving engine's refusal.

Inputs (patch embeddings, tokens) are drawn from seeded numpy generators;
the weights are `repro`'s `init_params(PRNGKey(0))` carried through numpy."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import run as jax_serve_run
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import model as JMODEL
from repro.models import steps as JS
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import (forward, greedy_generate, init_cache,
                                loss_fn, make_decode_step, make_eval_step,
                                make_prefill)
from repro_torch.models import model as MODEL
from repro_torch.models.convert import params_from_jax
from repro_torch.models.steps import _copy_prefix_cache
from repro_torch.serving.engine import EngineConfig, ServingEngine

ARCH = "pixtral-12b"
# the reference's limits (tests/test_kernels.py:12); losses 1e-4 relative
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def make_batch(cfg, B: int, S: int, seed: int = 0,
               patches: bool = True) -> dict:
    """Tokens and, with `patches`, the frontend's num_patches embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model), np.float32)
    return batch


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("smoke", [True, False])
def test_config_copied_as_data(smoke):
    port, ref = get_config(ARCH, smoke=smoke), jax_get_config(ARCH,
                                                             smoke=smoke)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.frontend == "patch" and port.enc_layers == 0
    if not smoke:
        assert (port.num_layers, port.d_model, port.num_heads,
                port.num_kv_heads, port.head_dim, port.d_ff, port.vocab_size,
                port.rope_theta, port.num_patches) == (
            40, 5120, 32, 8, 128, 14336, 131072, 1e6, 1024)


def test_params_from_jax_loads_every_leaf():
    jcfg, jparams, _, model = carry()
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
def test_patches_lead_the_tokens_and_are_scaled(dtype):
    """`_embed_inputs`: the patches cast to the model type before the token
    embeddings, the whole sequence times sqrt(d_model): bitwise `repro`'s."""
    jcfg, jparams, cfg, model = carry(dtype)
    batch = make_batch(cfg, 2, 6, seed=1)
    want = JMODEL._embed_inputs(jparams, jcfg, to_jax(batch))
    got = MODEL._embed_inputs(model, cfg, to_torch(batch))
    assert got.dtype == cfg.dtype
    assert tuple(got.shape) == (2, cfg.num_patches + 6, cfg.d_model)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("patches", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_logits_and_loss_match_jax(dtype, patches):
    """Train logits over patches and tokens, and `loss_fn` with the patch
    positions cut out (with and without patches in the batch)."""
    jcfg, jparams, cfg, model = carry(dtype)
    batch = make_batch(cfg, 2, 12, seed=2, patches=patches)
    want, jaux = jax_forward(jparams, jcfg, to_jax(batch), mode="train")
    got, aux = forward(model, cfg, to_torch(batch), mode="train")
    n_p = cfg.num_patches if patches else 0
    assert tuple(got.shape) == (2, n_p + 12, cfg.padded_vocab)
    close(got, want, dtype)
    assert float(aux) == float(jaux) == 0.0
    jloss, (jce, _) = JS.loss_fn(jparams, jcfg, batch)
    loss, (ce, _) = loss_fn(model, cfg, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_TOL[dtype])
    assert float(ce) == pytest.approx(float(jce), rel=LOSS_TOL[dtype])


def test_loss_cuts_the_patch_positions():
    """The loss is the text's alone: equal to the cross-entropy of the
    logits after the patches."""
    from repro_torch.models.steps import cross_entropy
    _, _, cfg, model = carry()
    batch = to_torch(make_batch(cfg, 2, 10, seed=3))
    logits, _ = forward(model, cfg, batch, mode="train")
    toks = batch["tokens"].long()
    mask = torch.ones(toks.shape)
    mask[:, -1] = 0.0
    want = cross_entropy(logits[:, cfg.num_patches:],
                         torch.cat([toks[:, 1:], toks[:, :1]], 1),
                         cfg.vocab_size, mask)
    loss, (ce, _) = loss_fn(model, cfg, batch)
    assert float(loss) == float(ce) == float(want)


def test_eval_step_matches_jax():
    jcfg, jparams, cfg, model = carry()
    batch = make_batch(cfg, 2, 16, seed=4)
    want = JS.make_eval_step(jcfg)(jparams, to_jax(batch))
    got = make_eval_step(cfg)(model, to_torch(batch))
    for key in ("loss", "ce"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    """The last-token logits and the cache of n_p + S rows."""
    jcfg, jparams, cfg, model = carry(dtype)
    batch = make_batch(cfg, 2, 11, seed=5)
    want, jcache, _ = jax_forward(jparams, jcfg, to_jax(batch),
                                  mode="prefill")
    got, cache, _ = forward(model, cfg, to_torch(batch), mode="prefill")
    close(got, want, dtype, "logits")
    assert set(cache[0]) == set(jcache[0]) == {"k", "v"}
    for name, leaf in cache[0].items():
        assert tuple(leaf.shape) == jcache[0][name].shape
        assert leaf.shape[2] == cfg.num_patches + 11
        close(leaf, jcache[0][name], dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_after_prefill_matches_jax(dtype):
    """A prompt of patches and tokens prefilled, then 10 decode steps of
    given tokens at positions n_p + S + i: the logits of every step."""
    jcfg, jparams, cfg, model = carry(dtype)
    B, S, steps = 2, 9, 10
    batch = make_batch(cfg, B, S, seed=6)
    S0 = cfg.num_patches + S
    _, jpre = JS.make_prefill(jcfg)(jparams, to_jax(batch))
    jcache = JS._copy_prefix_cache(jcfg, jpre,
                                   jax_init_cache(jcfg, B, S0 + steps))
    _, pre = make_prefill(cfg)(model, to_torch(batch))
    cache = _copy_prefix_cache(pre, init_cache(cfg, B, S0 + steps,
                                               device="cpu"))
    jdecode = jax.jit(JS.make_decode_step(jcfg))
    decode = make_decode_step(cfg)
    rng = np.random.default_rng(7)
    for i in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        want, jcache = jdecode(jparams, jcache, jnp.asarray(toks), S0 + i)
        got, cache = decode(model, cache, torch.from_numpy(toks), S0 + i)
        close(got, want, dtype, f"step {i}")


def test_greedy_generate_matches_jax():
    """fp32: the same token ids; the decode cache has room past the
    patches (S0 = n_p + S)."""
    jcfg, jparams, cfg, model = carry()
    batch = make_batch(cfg, 2, 14, seed=8)
    want = JS.greedy_generate(jcfg, jparams, to_jax(batch), 10)
    got = greedy_generate(cfg, model, to_torch(batch), 10)
    assert tuple(got.shape) == (2, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_refuses_a_patch_frontend_as_jax_does():
    jcfg, jparams, cfg, model = carry()
    with pytest.raises(AssertionError, match="plain decoder"):
        JaxServingEngine(jcfg, jparams, JaxEngineConfig(num_slots=2,
                                                        kv_capacity=16))
    with pytest.raises(ValueError, match="plain decoder"):
        ServingEngine(cfg, model, EngineConfig(num_slots=2, kv_capacity=16))


def test_serve_run_decodes_pixtral_on_cpu():
    """The serve entry point's decode step of token ids (no image), as in
    `repro`."""
    out = serve.run(ARCH, smoke=True, device="cpu", requests=20)
    ref = jax_serve_run(ARCH, smoke=True, requests=20)
    assert set(out) == set(ref) | {"decode_steps"}
    assert out["served"] == ref["served"] == 20
    assert out["offline_steps"] == 0 and out["decode_steps"] >= 6
