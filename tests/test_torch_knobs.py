"""`repro`'s ModelConfig knobs in the port, against the JAX package: the
config fields, `attention_chunked` and the dispatch that reaches it, the
logit cap on the plain kernels and where the models apply it (F8), the
fused loss, remat, and the train step past 4096 tokens; weights carried
across through numpy.  The capped kernels themselves are held on the card
in tests/test_torch_softcap_kernels.py, which imports no jax."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import steps as JS
from repro.models.model import ModelConfig as JaxModelConfig
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import forward, init_cache, init_params, loss_fn
from repro_torch.models import layers as L
from repro_torch.models import steps as S
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import ModelConfig
from repro_torch.optim import AdamW, AdamWConfig

# the reference's limits (tests/test_kernels.py:12) for attention; 1e-4
# relative for losses and fp32 model outputs
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOSS_TOL = 1e-4
KNOBS = dict(softcap=30.0, attn_impl="pallas", attn_force_chunked=True,
             fused_loss=True, remat=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one intra-op thread for this module: with a thread a
    core and the other test workers busy, OpenMP's barriers wait on
    descheduled threads, and these many small operations took several
    times their time alone (the tier-1 run's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def tokens(vocab: int, B: int, S_: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S_)).astype(
        np.int32)


# `repro`'s functions compiled whole, as its steps run them: op by op,
# each of their many small operations is compiled on its own (seconds a
# model on the CPU).  The config is static
jax_init = jax.jit(jax_init_params, static_argnums=1)
jax_loss = jax.jit(JS.loss_fn, static_argnums=1)
jax_run = jax.jit(jax_forward, static_argnums=1, static_argnames="mode")
# the loss and the train logits in one program
jax_loss_logits = jax.jit(lambda p, cfg, b: (
    JS.loss_fn(p, cfg, b)[0], jax_forward(p, cfg, b, mode="train")[0]),
    static_argnums=1)


def jitted(fn, *args, **kw):
    """`fn(*args, **kw)` compiled whole, the keyword arguments fixed."""
    return jax.jit(functools.partial(fn, **kw))(*args)


@functools.cache
def carry(arch: str, dtype: str = "float32"):
    """(jcfg, jparams, cfg, model): `repro`'s SMOKE model from PRNGKey(0)
    and the port's holding the same weights, on the CPU."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=getattr(jnp, dtype))
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(arch, smoke=True, dtype=getattr(torch, dtype))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jcfg, jparams, cfg, model


def knobbed(arch: str, dtype: str = "float32", **knobs):
    """`carry`'s pair with both configs given `knobs`."""
    jcfg, jparams, cfg, model = carry(arch, dtype)
    return (dataclasses.replace(jcfg, **knobs), jparams,
            dataclasses.replace(cfg, **knobs), model)


def f32(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def grads_of(model, cfg, batch):
    """(loss, every weight's gradient by name) of `loss_fn` under autograd."""
    weights = dict(model.named_parameters())
    for w in weights.values():
        w.requires_grad_(True)
    try:
        loss, _ = loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(weights.values()))
    finally:
        for w in weights.values():
            w.requires_grad_(False)
    return loss.detach(), dict(zip(weights, grads))


# ------------------------------------------------------------- the config

def test_config_has_every_field_of_repros():
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    ref = {f.name for f in dataclasses.fields(JaxModelConfig)}
    assert port == ref, (port ^ ref)
    for name in KNOBS:
        assert (getattr(ModelConfig, name) ==
                getattr(JaxModelConfig, name)), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_get_config_takes_every_knob(arch):
    for smoke in (True, False):
        port = get_config(arch, smoke=smoke, **KNOBS)
        ref = jax_get_config(arch, smoke=smoke, **KNOBS)
        for name, val in KNOBS.items():
            assert getattr(port, name) == getattr(ref, name) == val, name


# ---------------------------------------------------- attention_chunked

# (name, Sq, Skv, H, Hk, dh, dv, kwargs); chunks of 128 as in
# tests/test_kernels.py:85
CHUNKED = [
    ("causal_gqa", 256, 256, 4, 2, 16, 16, dict(causal=True)),
    ("window_masks_chunks", 384, 384, 4, 2, 16, 16,
     dict(causal=True, window=100)),
    ("softcap", 256, 256, 4, 2, 16, 16, dict(causal=True, softcap=5.0)),
    ("q_offset", 256, 384, 4, 2, 16, 16, dict(causal=True, q_offset=128)),
    ("kv_len", 256, 384, 4, 4, 16, 16, dict(causal=False, kv_len=300)),
    ("mla_narrow_v", 256, 256, 4, 4, 24, 16,
     dict(causal=True, softcap=2.0)),
    ("window_no_causal", 256, 256, 2, 1, 16, 16,
     dict(causal=False, window=64)),
]


def chunked_inputs(Sq, Skv, H, Hk, dh, dv, seed=0):
    return (normal((2, Sq, H, dh), seed, 2.0), normal((2, Skv, Hk, dh),
                                                      seed + 1, 2.0),
            normal((2, Skv, Hk, dv), seed + 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,Sq,Skv,H,Hk,dh,dv,kw", CHUNKED,
                         ids=[c[0] for c in CHUNKED])
def test_attention_chunked_matches_jax(dtype, name, Sq, Skv, H, Hk, dh, dv,
                                       kw):
    q, k, v = chunked_inputs(Sq, Skv, H, Hk, dh, dv)
    want = JL.attention_chunked(*(jnp.asarray(a, getattr(jnp, dtype))
                                  for a in (q, k, v)), chunk_q=128,
                                chunk_k=128, **kw)
    got = L.attention_chunked(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                for a in (q, k, v)), chunk_q=128,
                              chunk_k=128, **kw)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (2, Sq, H, dv)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("name,Sq,Skv,H,Hk,dh,dv,kw", CHUNKED,
                         ids=[c[0] for c in CHUNKED])
def test_skipping_hidden_chunks_keeps_the_bits(name, Sq, Skv, H, Hk, dh, dv,
                                               kw, monkeypatch):
    """The chunks every row of a query chunk cannot see are skipped; the
    output is bitwise that of the loop over every chunk, as `repro` runs
    it (its garbage in a row's leading masked chunks is wiped exactly)."""
    args = dict(chunk_q=128, chunk_k=128, **kw)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in chunked_inputs(Sq, Skv, H, Hk, dh, dv, seed=3))
        skipped = L.attention_chunked(q, k, v, **args)
        with monkeypatch.context() as m:
            m.setattr(L, "_visible_chunks", lambda *a: None)
            every = L.attention_chunked(q, k, v, **args)
        assert torch.equal(skipped, every)


def test_hidden_chunks_are_skipped():
    """Which chunks the test skips: a window of 100 at chunks of 128 hides
    chunk 0 from query chunk 2; a row that sees no key keeps every chunk."""
    vis = L._visible_chunks(True, 100, 0, None, 384)
    assert [[vis(qi * 128, 128, ki * 128, 128) for ki in range(3)]
            for qi in range(3)] == [[True, False, False], [True, True, False],
                                    [False, True, True]]
    # kv_len 10: every row sees keys 0..9 only, so chunk 1 is hidden ...
    assert not L._visible_chunks(True, None, 0, 10, 384)(256, 128, 128, 128)
    # ... but with a window of 5 too, rows past 13 see no key: no skip
    assert L._visible_chunks(True, 5, 0, 10, 384)(256, 128, 128, 128)
    assert L._visible_chunks(True, None, torch.tensor(0), None, 384) is None


@pytest.mark.parametrize("name,Sq,Skv,H,Hk,dh,dv,kw",
                         [c for c in CHUNKED if "q_offset" not in c[7]
                          and "kv_len" not in c[7]],
                         ids=[c[0] for c in CHUNKED if "q_offset" not in c[7]
                              and "kv_len" not in c[7]])
def test_chunked_gradient_matches_materialised(name, Sq, Skv, H, Hk, dh, dv,
                                               kw):
    """Under autograd (each KV chunk recomputed in the backward) the
    chunked form's gradients of q, k and v are the materialised form's."""
    def run(fn):
        ins = [torch.from_numpy(a).requires_grad_(True)
               for a in chunked_inputs(Sq, Skv, H, Hk, dh, dv, seed=5)]
        w = torch.from_numpy(normal((2, Sq, H, dv), 9))
        (fn(*ins) * w).sum().backward()
        return [t.grad for t in ins]
    got = run(lambda q, k, v: L.attention_chunked(q, k, v, chunk_q=128,
                                                  chunk_k=128, **kw))
    want = run(lambda q, k, v: L.attention(q, k, v, **kw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("Sq,Skv,force,want", [
    (4096, 4096, False, False),      # at the limit: materialised
    (4096, 6144, False, True),       # past it, the chunks divide
    (8192, 8192, False, True),
    (4100, 4100, False, False),      # past it, they do not: materialised
    (6144, 4100, False, False),
    (1, 1 << 25, False, False),      # one query
    (2048, 2048, True, True),        # forced
    (2048, 1000, True, False),       # forced, not divisible
    (2, 4096, True, False),
])
def test_dispatch_is_repros(Sq, Skv, force, want):
    assert L.chunked(Sq, Skv, force) is want
    # `repro`'s predicate, inline in its `attention` (layers.py:115-116)
    assert ((force or Sq * Skv > JL._MATERIALIZE_LIMIT) and Sq > 1
            and Sq % JL._CHUNK_Q == 0 and Skv % JL._CHUNK_K == 0) is want


@pytest.mark.parametrize("Sq,Skv,causal", [(2048, 10240, False),
                                           (4100, 4100, True)])
def test_attention_past_the_limit_matches_jax(Sq, Skv, causal):
    """Past 4096**2 scores a head: streamed where the chunks divide,
    materialised where they do not, in both packages."""
    q, k, v = normal((1, Sq, 2, 8), 1), normal((1, Skv, 1, 8), 2), \
        normal((1, Skv, 1, 8), 3)
    want = jitted(JL.attention, jnp.asarray(q), jnp.asarray(k),
                  jnp.asarray(v), causal=causal, softcap=3.0)
    got = L.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                      causal=causal, softcap=3.0)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


# -------------------------------------------- the cap on the plain kernels

@pytest.mark.parametrize("softcap", [None, 50.0, 5.0])
@pytest.mark.parametrize("H,Hk,causal,window", [(4, 2, True, None),
                                                (4, 4, True, 7),
                                                (2, 1, False, None)])
def test_capped_flash_plain_matches_repros_attention(softcap, H, Hk, causal,
                                                     window):
    q, k, v = normal((2, 20, H, 16), 0, 4.0), normal((2, 20, Hk, 16), 1,
                                                     4.0), \
        normal((2, 20, Hk, 16), 2)
    want = jitted(JL.attention, jnp.asarray(q), jnp.asarray(k),
                  jnp.asarray(v), causal=causal, window=window,
                  softcap=softcap)
    got = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window,
                                   softcap=softcap)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("softcap", [None, 50.0, 5.0])
@pytest.mark.parametrize("H,Hk", [(8, 2), (4, 4)])
def test_capped_decode_plain_matches_repros_decode(softcap, H, Hk):
    """Against `repro`'s grouped decode attention (G > 1) and its dense
    path (MHA), both with the cap, at per-row lengths."""
    B, Skv = 3, 40
    q, k, v = normal((B, 1, H, 16), 3, 4.0), normal((B, Skv, Hk, 16), 4,
                                                    4.0), \
        normal((B, Skv, Hk, 16), 5)
    lens = np.array([1, 17, 40], np.int32)
    fn = JL._attention_gqa_decode if H != Hk else JL.attention
    want = jitted(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, window=None, q_offset=jnp.asarray(lens - 1),
                  kv_len=jnp.asarray(lens), softcap=softcap)
    got = da.decode_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    torch.from_numpy(lens), softcap)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


# ------------------------------------------------- the cap in the models

@functools.cache
def _jit_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: jax_forward(
        p, jcfg, {"tokens": t}, mode="decode", cache=c, pos=pos))


def jax_decode(jcfg, jparams, cache, toks, pos):
    return _jit_decode(jcfg)(jparams, cache, jnp.asarray(toks),
                             jnp.asarray(pos, jnp.int32))


def decode_both(arch, knobs, B=2, S0=6, steps=5, cap=None, src=0):
    """Logits of a prefill then `steps` decode steps in both packages, from
    a cache of `cap` rows (S0 + steps by default), fp32."""
    jcfg, jparams, cfg, model = knobbed(arch, **knobs)
    cap = cap or S0 + steps
    batch = {"tokens": tokens(cfg.vocab_size, B, S0, seed=1)}
    if cfg.enc_layers:
        batch["src_embeds"] = normal((B, 5, cfg.d_model), 7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jc, _ = jax_run(jparams, jcfg, jb, mode="prefill")
    tl, tc, _ = forward(model, cfg, tb, mode="prefill")
    jcache = JS._copy_prefix_cache(jcfg, jc, jax_init_cache(
        jcfg, B, cap, src_len=5 if cfg.enc_layers else 0))
    cache = S._copy_prefix_cache(tc, init_cache(
        cfg, B, cap, src_len=5 if cfg.enc_layers else 0, device="cpu"))
    out = [(jl, tl)]
    rng = np.random.default_rng(2)
    for i in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jax_decode(jcfg, jparams, jcache, toks, S0 + i)
        tl, _ = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                        mode="decode", cache=cache, pos=S0 + i)
        out.append((jl, tl))
    return out


def train_batch(cfg, B=2, S_=12) -> dict:
    batch = {"tokens": tokens(cfg.vocab_size, B, S_, seed=4)}
    if cfg.enc_layers:
        batch["src_embeds"] = normal((B, 5, cfg.d_model), 7)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = normal((B, cfg.num_patches, cfg.d_model), 8)
    return batch


def train_both(arch, knobs, logits: bool = True):
    """((repro's loss, the port's), (repro's train logits, the port's)),
    the logits None unless asked."""
    jcfg, jparams, cfg, model = knobbed(arch, **knobs)
    batch = train_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = loss_fn(model, cfg, tb)
    if not logits:
        jloss, _ = jax_loss(jparams, jcfg, jb)
        return (float(jloss), float(loss)), (None, None)
    jloss, jlogits = jax_loss_logits(jparams, jcfg, jb)
    return (float(jloss), float(loss)), (
        jlogits, forward(model, cfg, tb, mode="train")[0])


def port_train_logits(arch, knobs):
    _, _, cfg, model = knobbed(arch, **knobs)
    return forward(model, cfg, {k: torch.from_numpy(v) for k, v in
                                train_batch(cfg).items()}, mode="train")[0]


def test_gemma_softcap_matches_jax_in_every_mode():
    """gemma-7b (MHA) capped at 2.0, so that the cap bites: train logits and
    loss, the prefill's logits and decode steps against `repro`'s."""
    (jloss, loss), (jl, tl) = train_both("gemma-7b", dict(softcap=2.0))
    assert loss == pytest.approx(jloss, rel=LOSS_TOL)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=1e-4, rtol=1e-4)
    plain = port_train_logits("gemma-7b", {})
    assert not np.allclose(f32(tl), f32(plain), atol=1e-3)   # the cap bites
    for i, (jl, tl) in enumerate(decode_both("gemma-7b", dict(softcap=2.0),
                                             steps=2)):
        np.testing.assert_allclose(f32(tl), f32(jl), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}")


def decode_steps(arch, knobs, cap: int, steps: int, B: int = 2):
    """Logits of `steps` decode steps from an empty cache of `cap` rows at
    positions 0, 1, ..., in both packages, fp32."""
    jcfg, jparams, cfg, model = knobbed(arch, **knobs)
    jcache = jax_init_cache(jcfg, B, cap)
    cache = init_cache(cfg, B, cap, device="cpu")
    rng = np.random.default_rng(2)
    out = []
    for i in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jax_decode(jcfg, jparams, jcache, toks, i)
        tl, _ = forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                        mode="decode", cache=cache, pos=i)
        out.append((f32(jl), f32(tl)))
    return out


def test_ring_decode_is_never_capped():
    """F8: h2o-danube-1.8b on its ring (capacity = the window, 16), 20
    steps, past the window: decode with a cap equals decode without, bit
    for bit, in both packages; on a plain cache (8 rows, below the
    window) the same steps are capped in both."""
    arch = "h2o-danube-1.8b"
    ring = decode_steps(arch, dict(softcap=1.0), cap=16, steps=20)
    free = decode_steps(arch, {}, cap=16, steps=20)
    for (jc, tc), (jf, tf) in zip(ring, free):
        np.testing.assert_array_equal(tc, tf)
        np.testing.assert_array_equal(jc, jf)
        np.testing.assert_allclose(tc, jc, atol=1e-4, rtol=1e-4)
    plain = decode_steps(arch, dict(softcap=1.0), cap=8, steps=8)
    free = decode_steps(arch, {}, cap=8, steps=8)
    for (jc, tc) in plain:
        np.testing.assert_allclose(tc, jc, atol=1e-4, rtol=1e-4)
    assert not np.allclose(plain[-1][1], free[-1][1], atol=1e-3)
    assert not np.allclose(plain[-1][0], free[-1][0], atol=1e-3)


def test_mla_is_never_capped():
    """F8: deepseek-v2-lite-16b (MLA): train logits with a cap equal those
    without in both packages (and the port's loss is `repro`'s); the
    port's prefill and decode too."""
    (jc, tc), (jcl, tcl) = train_both("deepseek-v2-lite-16b",
                                      dict(softcap=1.0))
    jcfg, jparams, _, _ = knobbed("deepseek-v2-lite-16b")
    # the same program as train_both's, so that equal means uncapped
    jpl = jax_loss_logits(jparams, jcfg, {k: jnp.asarray(v) for k, v in
                                          train_batch(jcfg).items()})[1]
    assert tc == pytest.approx(jc, rel=LOSS_TOL)
    np.testing.assert_array_equal(f32(tcl), f32(port_train_logits(
        "deepseek-v2-lite-16b", {})))
    np.testing.assert_array_equal(f32(jcl), f32(jpl))
    runs = []
    for knobs in (dict(softcap=1.0), {}):
        _, _, cfg, model = knobbed("deepseek-v2-lite-16b", **knobs)
        toks = torch.from_numpy(tokens(cfg.vocab_size, 2, 6, seed=1))
        logits, pre, _ = forward(model, cfg, {"tokens": toks},
                                 mode="prefill")
        cache = S._copy_prefix_cache(pre, init_cache(cfg, 2, 8,
                                                     device="cpu"))
        step, _ = forward(model, cfg, {"tokens": toks[:, :1]},
                          mode="decode", cache=cache, pos=6)
        runs.append((logits, step))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_encoder_and_cross_attention_are_never_capped(monkeypatch):
    """F8: seamless-m4t-medium caps its decoder's self-attention only (it is
    GQA self-attention in `repro` too), never the encoder or the cross
    attention: with a cap the port equals `repro` in train, prefill and
    decode, and capping the port's cross attention or encoder as well
    would move it off `repro`'s."""
    (jloss, loss), (jl, tl) = train_both("seamless-m4t-medium",
                                         dict(softcap=1.0))
    assert loss == pytest.approx(jloss, rel=LOSS_TOL)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=1e-4, rtol=1e-4)
    for i, (jd, td) in enumerate(decode_both("seamless-m4t-medium",
                                             dict(softcap=1.0), steps=3)):
        np.testing.assert_allclose(f32(td), f32(jd), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}")
    # a cap everywhere (a port that capped the encoder and cross attention
    # too) would be off `repro`'s by far more than the limit
    jcfg, jparams, cfg, model = knobbed("seamless-m4t-medium",
                                        softcap=1.0)
    batch = {"tokens": torch.from_numpy(tokens(cfg.vocab_size, 2, 12, 4)),
             "src_embeds": torch.from_numpy(normal((2, 5, cfg.d_model), 7))}
    monkeypatch.setattr(L, "attention",
                        functools.partial(L.attention, softcap=1.0))
    wrong, _ = forward(model, cfg, batch, mode="train")
    assert not np.allclose(f32(wrong), f32(jl), atol=1e-3)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma-7b"])
def test_forced_chunks_at_4096_match_jax(arch):
    """attn_force_chunked at S 4096 (two chunks each way; danube's window
    of 16 hides whole chunks): the train loss against `repro`'s."""
    jcfg, jparams, cfg, model = knobbed(arch, attn_force_chunked=True,
                                        softcap=5.0 if arch == "gemma-7b"
                                        else None)
    batch = {"tokens": tokens(cfg.vocab_size, 1, 4096, seed=3)}
    jloss, _ = jax_loss(jparams, jcfg, {"tokens": jnp.asarray(
        batch["tokens"])})
    with torch.no_grad():
        loss, _ = loss_fn(model, cfg, batch)
        plain, _ = loss_fn(model, dataclasses.replace(
            cfg, attn_force_chunked=False), batch)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_TOL)
    assert float(loss) == pytest.approx(float(plain), rel=LOSS_TOL)


# ----------------------------------------------------------- fused loss

@pytest.mark.parametrize("Vpad,chunk", [(96, 32), (96, 40), (80, 8192)])
def test_chunked_cross_entropy_matches_jax(Vpad, chunk):
    """A chunk that divides Vpad, one that does not (gcd(96, 40) = 8
    columns) and one wider than the vocabulary; the padded columns past
    vocab_size (Vpad - 6) are excluded."""
    V = Vpad - 6
    x, w = normal((2, 7, 16), 0), normal((16, Vpad), 1, 0.5)
    targets = np.random.default_rng(2).integers(0, V, (2, 7))
    mask = np.ones((2, 7), np.float32)
    mask[:, -1] = 0
    want = jitted(JS.chunked_cross_entropy, jnp.asarray(x), jnp.asarray(w),
                  jnp.asarray(targets), vocab_size=V, mask=jnp.asarray(mask),
                  chunk=chunk)
    got = S.chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(targets), V,
                                  torch.from_numpy(mask), chunk=chunk)
    unfused = S.cross_entropy(torch.from_numpy(x) @ torch.from_numpy(w),
                              torch.from_numpy(targets), V,
                              torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)
    assert float(got) == pytest.approx(float(unfused), rel=LOSS_TOL)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "pixtral-12b",
                                  "deepseek-v2-lite-16b"])
def test_fused_loss_matches_jax_and_the_unfused_one(arch):
    """loss_fn with fused_loss (the patch positions cut from the hiddens
    for pixtral-12b, the MoE's aux loss added for deepseek-v2-lite-16b)
    against `repro`'s fused loss, and the port's fused loss and gradients
    against its unfused ones."""
    (jloss, loss), _ = train_both(arch, dict(fused_loss=True))
    assert loss == pytest.approx(jloss, rel=LOSS_TOL)
    _, _, cfg, model = knobbed(arch)
    batch = {"tokens": torch.from_numpy(tokens(cfg.vocab_size, 2, 12, 4))}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = torch.from_numpy(
            normal((2, cfg.num_patches, cfg.d_model), 8))
    fl, fg = grads_of(model, dataclasses.replace(cfg, fused_loss=True),
                      batch)
    ul, ug = grads_of(model, cfg, batch)
    assert float(fl) == pytest.approx(float(ul), rel=LOSS_TOL)
    for name, g in fg.items():
        np.testing.assert_allclose(g.numpy(), ug[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(ug[name].abs().max()),
                                   err_msg=name)


def test_train_hidden_is_the_normed_hiddens():
    _, _, cfg, model = knobbed("h2o-danube-1.8b")
    batch = {"tokens": torch.from_numpy(tokens(cfg.vocab_size, 2, 9, 5))}
    hidden, aux = forward(model, cfg, batch, mode="train_hidden")
    logits, aux2 = forward(model, cfg, batch, mode="train")
    assert tuple(hidden.shape) == (2, 9, cfg.d_model)
    assert torch.equal(hidden @ model.lm_head, logits)
    assert float(aux) == float(aux2)


# -------------------------------------------------------------- remat

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "seamless-m4t-medium",
                                  "jamba-1.5-large-398b"])
def test_remat_changes_no_bit_of_a_train_step(arch):
    """An AdamW step with remat on and off, on the CPU: the same metrics
    and new weights bit for bit (jamba's 8-position super-block, the MoE
    aux summed across it, and seamless's encoder blocks); with remat on
    (the default) the loss is `repro`'s, which remats too."""
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    batch = train_batch(cfg)
    runs = []
    for remat in (True, False):
        model = init_params(torch.Generator().manual_seed(0), cfg)
        c = dataclasses.replace(cfg, remat=remat)
        opt = AdamW(AdamWConfig(lr=1e-3, total_steps=10))
        _, _, m = S.make_train_step(c, opt)(
            model, opt.init(list(model.parameters())),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        runs.append((m, list(model.parameters())))
    (m1, w1), (m2, w2) = runs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))
    if arch != "jamba-1.5-large-398b":      # its JAX init alone takes 8 s
        (jloss, loss), _ = train_both(arch, {}, logits=False)
        assert loss == pytest.approx(jloss, rel=LOSS_TOL)
