"""The port's seamless-m4t-medium (an encoder over stub frame embeddings and
a decoder with cross-attention, ReLU FFNs) against the JAX package at
SMOKE: the config copied as data, the weights carried across (the encoder
included), ReLU, the encoder, the train logits and loss, prefill and every
cache leaf (the cross keys and values too), decode against the cross cache,
greedy generation, the cache layout, the serve entry point, the engine's
refusal, and the reference's condition F6 (a tokens-only train batch
raises in both packages).

Inputs (source embeddings, tokens) are drawn from seeded numpy generators;
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
from repro.launch.train import run as jax_train_run
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import model as JMODEL
from repro.models import steps as JS
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import (forward, greedy_generate, init_cache,
                                loss_fn, make_decode_step, make_prefill)
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL
from repro_torch.models.convert import params_from_jax
from repro_torch.models.steps import _copy_prefix_cache
from repro_torch.serving.engine import EngineConfig, ServingEngine

ARCH = "seamless-m4t-medium"
# the reference's limits (tests/test_kernels.py:12); losses 1e-4 relative
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SRC = 10                                      # source frames


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


def make_batch(cfg, B: int, S: int, seed: int = 0, src: int = SRC) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "src_embeds": rng.standard_normal((B, src, cfg.d_model),
                                              np.float32)}


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
    assert port.pattern == (("attn_cross", "dense"),)
    assert port.ffn_act == "relu" and port.frontend == "audio"
    if not smoke:
        assert (port.num_layers, port.enc_layers, port.d_model,
                port.num_heads, port.num_kv_heads, port.head_dim, port.d_ff,
                port.vocab_size, port.padded_vocab) == (
            12, 12, 1024, 16, 16, 64, 4096, 256206, 256256)


def test_params_from_jax_loads_every_leaf():
    """Strictly, the encoder's stacked blocks and final norm included."""
    jcfg, jparams, cfg, model = carry()
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()
    assert len(model.enc_blocks) == cfg.enc_layers
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("blocks", "enc_blocks"):
            stack = jparams["blocks"][0] if parts[0] == "blocks" \
                else jparams["enc_blocks"]
            leaf = stack[parts[2]][parts[3]][int(parts[1])]
        else:
            leaf = jparams[parts[0]] if len(parts) == 1 \
                else jparams[parts[0]][parts[1]]
        np.testing.assert_array_equal(p.numpy(), np.asarray(leaf),
                                      err_msg=name)
    assert hasattr(model.blocks[0], "cross") and not hasattr(
        model.enc_blocks[0], "cross")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_ffn_matches_jax(dtype):
    """jax.nn.relu is exact, as F.relu is: block 0's FFN on one input."""
    _, jparams, cfg, model = carry(dtype)
    jffn = jax.tree.map(lambda a: a[0], jparams["blocks"][0])["ffn"]
    x = np.random.default_rng(1).standard_normal((2, 8, cfg.d_model),
                                                 np.float32)
    want = JL.ffn(jffn, jnp.asarray(x, getattr(jnp, dtype)), "relu")
    got = L.ffn(model.blocks[0].ffn, torch.from_numpy(x).to(cfg.dtype),
                cfg.ffn_act)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    v = np.linspace(-3, 3, 601, dtype=np.float32)
    np.testing.assert_array_equal(
        f32(L.ACTS["relu"](torch.from_numpy(v).to(cfg.dtype))),
        f32(jax.nn.relu(jnp.asarray(v, getattr(jnp, dtype)))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    """The bidirectional encoder (rotary at arange(S_src), non-causal) over
    the same frames, with the train attention and with the prefill's."""
    from repro_torch.kernels import ops
    jcfg, jparams, cfg, model = carry(dtype)
    src = make_batch(cfg, 2, 4, seed=2)["src_embeds"]
    want = JMODEL._encoder_forward(jparams, jcfg, jnp.asarray(src))
    for attend in (L.attention, ops.flash_attention):
        got = MODEL._encoder_forward(model, cfg, {"src_embeds": src}, attend)
        assert got.dtype == cfg.dtype
        close(got, want, dtype)


def test_cross_attention_has_no_rotary():
    """Cross queries, keys and values are plain projections."""
    _, _, cfg, model = carry()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, cfg.d_model), np.float32))
    cross = model.blocks[0].cross
    q = L.cross_project_q(cross, x, cfg)
    k, v = L.cross_project_kv(cross, x, cfg)
    shape = (2, 5, cfg.num_heads, cfg.head_dim)
    assert torch.equal(q, (x @ cross.w_q).reshape(shape))
    assert torch.equal(k, (x @ cross.w_k).reshape(shape))
    assert torch.equal(v, (x @ cross.w_v).reshape(shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_logits_and_loss_match_jax(dtype):
    jcfg, jparams, cfg, model = carry(dtype)
    batch = make_batch(cfg, 2, 12, seed=4)
    want, _ = jax_forward(jparams, jcfg, to_jax(batch), mode="train")
    got, aux = forward(model, cfg, to_torch(batch), mode="train")
    assert tuple(got.shape) == (2, 12, cfg.padded_vocab)
    close(got, want, dtype)
    assert float(aux) == 0.0
    jloss, (jce, _) = JS.loss_fn(jparams, jcfg, batch)
    loss, (ce, _) = loss_fn(model, cfg, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_TOL[dtype])
    assert float(ce) == pytest.approx(float(jce), rel=LOSS_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    """The last-token logits and every cache leaf: the self-attention's k
    and v, and the encoder's cross keys and values xk, xv (S_src rows)."""
    jcfg, jparams, cfg, model = carry(dtype)
    batch = make_batch(cfg, 2, 9, seed=5)
    want, jcache, _ = jax_forward(jparams, jcfg, to_jax(batch),
                                  mode="prefill")
    got, cache, _ = forward(model, cfg, to_torch(batch), mode="prefill")
    close(got, want, dtype, "logits")
    assert set(cache[0]) == set(jcache[0]) == {"k", "v", "xk", "xv"}
    for name, leaf in cache[0].items():
        assert tuple(leaf.shape) == jcache[0][name].shape
        assert leaf.shape[2] == (SRC if name.startswith("x") else 9)
        close(leaf, jcache[0][name], dtype, name)


def test_cache_layout_matches_jax():
    jcfg, _, cfg, _ = carry()
    want = jax_init_cache(jcfg, 3, 16, src_len=SRC)[0]
    got = init_cache(cfg, 3, 16, src_len=SRC, device="cpu")[0]
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape, name
        assert not got[name].any()


def test_copy_prefix_cache_carries_the_cross_cache():
    _, _, cfg, model = carry()
    _, pre = make_prefill(cfg)(model, to_torch(make_batch(cfg, 2, 6)))
    cache = _copy_prefix_cache(pre, init_cache(cfg, 2, 12, src_len=SRC,
                                               device="cpu"))
    for name in ("xk", "xv"):
        assert torch.equal(cache[0][name], pre[0][name])
    assert torch.equal(cache[0]["k"][:, :, :6], pre[0]["k"])
    assert not cache[0]["k"][:, :, 6:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_after_prefill_matches_jax(dtype):
    """Prefill, then 10 decode steps of given tokens against the self cache
    and the cross cache: the logits of every step."""
    jcfg, jparams, cfg, model = carry(dtype)
    B, S, steps = 2, 7, 10
    batch = make_batch(cfg, B, S, seed=6)
    _, jpre = JS.make_prefill(jcfg)(jparams, to_jax(batch))
    jcache = JS._copy_prefix_cache(
        jcfg, jpre, jax_init_cache(jcfg, B, S + steps, src_len=SRC))
    _, pre = make_prefill(cfg)(model, to_torch(batch))
    cache = _copy_prefix_cache(pre, init_cache(cfg, B, S + steps,
                                               src_len=SRC, device="cpu"))
    jdecode = jax.jit(JS.make_decode_step(jcfg))
    decode = make_decode_step(cfg)
    rng = np.random.default_rng(7)
    for i in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        want, jcache = jdecode(jparams, jcache, jnp.asarray(toks), S + i)
        got, cache = decode(model, cache, torch.from_numpy(toks), S + i)
        close(got, want, dtype, f"step {i}")


def test_greedy_generate_matches_jax():
    """fp32: the same token ids; the cross cache sized from src_embeds."""
    jcfg, jparams, cfg, model = carry()
    batch = make_batch(cfg, 2, 8, seed=8, src=13)
    want = JS.greedy_generate(jcfg, jparams, to_jax(batch), 10)
    got = greedy_generate(cfg, model, to_torch(batch), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_needs_a_filled_cross_cache():
    _, _, cfg, model = carry()
    cache = init_cache(cfg, 2, 8, device="cpu")          # src_len 0
    with pytest.raises(ValueError, match="src_len"):
        forward(model, cfg, {"tokens": torch.zeros(2, 1, dtype=torch.long)},
                mode="decode", cache=cache, pos=0)


def test_engine_refuses_an_encoder_as_jax_does():
    jcfg, jparams, cfg, model = carry()
    with pytest.raises(AssertionError, match="plain decoder"):
        JaxServingEngine(jcfg, jparams, JaxEngineConfig(num_slots=2,
                                                        kv_capacity=16))
    with pytest.raises(ValueError, match="plain decoder"):
        ServingEngine(cfg, model, EngineConfig(num_slots=2, kv_capacity=16))


def test_serve_run_decodes_against_a_cross_cache_on_cpu():
    """`serve.run` sizes a cross cache of kv_cap rows (`repro`'s src_len),
    and its decode steps run on the CPU."""
    out = serve.run(ARCH, smoke=True, device="cpu", requests=20, kv_cap=32)
    ref = jax_serve_run(ARCH, smoke=True, requests=20, kv_cap=32)
    assert set(out) == set(ref) | {"decode_steps"}
    assert out["served"] == ref["served"] == 20
    assert out["offline_steps"] == 0 and out["decode_steps"] >= 6


# ------------------------------------------------ F6, a condition of repro

def test_tokens_only_train_forward_raises_in_both():
    """F6: the train forward of a tokens-only batch raises KeyError in
    `repro` (`model.py:438`) and in the port."""
    jcfg, jparams, cfg, model = carry()
    toks = make_batch(cfg, 2, 8)["tokens"]
    with pytest.raises(KeyError, match="src_embeds"):
        jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                    mode="train")
    with pytest.raises(KeyError, match="F6"):
        forward(model, cfg, {"tokens": torch.from_numpy(toks)}, mode="train")


def test_train_launcher_and_share_raise_in_both():
    """F6: the token pipeline gives tokens only, so `launch/train.py` and
    `serve --share` raise for seamless-m4t-medium in both packages."""
    kw = dict(smoke=True, steps=2, batch=2, seq=8)
    with pytest.raises(KeyError, match="src_embeds"):
        jax_train_run(ARCH, **kw)
    with pytest.raises(KeyError, match="F6"):
        train.run(ARCH, device="cpu", **kw)
    with pytest.raises(KeyError, match="src_embeds"):
        jax_serve_run(ARCH, smoke=True, share=True, requests=5, kv_cap=16)
    with pytest.raises(KeyError, match="F6"):
        serve.run(ARCH, smoke=True, device="cpu", share=True, requests=5,
                  kv_cap=16)
