"""The port's xlstm-350m train path against the JAX model: config, parameter
count, the mLSTM mixer and its sequential oracle, the loss with a padded
vocabulary, momentum SGD, the token pipeline, and whole train steps from
weights carried across through numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import (cross_entropy, init_params, loss_fn,
                                make_train_step)
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import MomentumSGD, MomentumSGDConfig, global_norm

ARCH = "xlstm-350m"
# fp32: two frameworks' matmul and transcendental orders; bf16: the
# reference's bf16 limit (tests/test_kernels.py:12)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def configs(dtype):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=getattr(jnp, dtype))
    cfg = get_config(ARCH, smoke=True, dtype=getattr(torch, dtype))
    return jcfg, cfg


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def carried(request):
    dtype = request.param
    jcfg, cfg = configs(dtype)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return dtype, jcfg, jparams, cfg, model


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.mark.parametrize("smoke", [True, False])
def test_config_copied_as_data(smoke):
    port, ref = get_config(ARCH, smoke=smoke), jax_get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(port):
        if f.name != "dtype":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert port.padded_vocab == ref.padded_vocab


@pytest.mark.parametrize("arch", [ARCH, "mistral-nemo-12b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_matches_reference(arch, smoke):
    assert get_config(arch, smoke=smoke).param_count() == \
        jax_get_config(arch, smoke=smoke).param_count()


def test_carried_model_holds_every_parameter(carried):
    _, jcfg, _, _, model = carried
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()
    mixer = model.blocks[1].mixer
    assert mixer.w_i.dtype == mixer.b_f.dtype == torch.float32
    assert mixer.w_q.dtype == model.embed.dtype


def test_init_params_draws_like_reference():
    cfg = get_config(ARCH, smoke=True, dtype=torch.float32)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    mixer = model.blocks[0].mixer
    assert torch.equal(mixer.b_f, torch.full((cfg.num_heads,), 3.0))
    assert torch.equal(mixer.b_i, torch.zeros(cfg.num_heads))
    assert torch.equal(mixer.gn_scale, torch.ones(2 * cfg.d_model))
    assert float(mixer.w_i.abs().max()) <= 0.04
    assert float(mixer.conv_w.abs().max()) <= 1.0
    assert float(mixer.w_q.abs().max()) <= 2 / np.sqrt(2 * cfg.d_model)
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.05)


def test_mlstm_mixer_vs_jax(carried):
    dtype, jcfg, jparams, cfg, model = carried
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model),
                                                 np.float32)
    jmix = jax.tree.map(lambda a: a[0], jparams["blocks"][0])["mixer"]
    jx = jnp.asarray(x).astype(jcfg.dtype)
    want_chunked, jcarry = JS.mlstm_mixer(jmix, jx, jcfg)
    want_ref = JS.mlstm_mixer_ref(jmix, jx, jcfg)
    tx = torch.from_numpy(x).to(cfg.dtype)
    got_chunked, carry = S.mlstm_mixer(model.blocks[0].mixer, tx, cfg)
    got_ref = S.mlstm_mixer_ref(model.blocks[0].mixer, tx, cfg)
    tol = TOL[dtype]
    for got, want in ((got_chunked, want_chunked), (got_ref, want_ref),
                      (got_chunked, want_ref)):
        np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    for got, want in zip(carry, jcarry):
        np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def test_mlstm_chunk_gradients_are_finite():
    """The -inf mask above the diagonal leaves no inf or nan in the
    backward pass."""
    cfg = get_config(ARCH, smoke=True, dtype=torch.float32)
    model = init_params(torch.Generator().manual_seed(1), cfg)
    mixer = model.blocks[0].mixer
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    for p in mixer.parameters():
        p.requires_grad_(True)
    y, _ = S.mlstm_mixer(mixer, x, cfg)
    y.square().sum().backward()
    grads = [x.grad] + [p.grad for p in mixer.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)


def test_cross_entropy_padded_vocab_vs_jax():
    from repro.models.steps import cross_entropy as jax_ce
    full = get_config(ARCH)
    V, Vpad = full.vocab_size, full.padded_vocab
    assert Vpad == 50432 > V == 50304
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((2, 4, Vpad))).astype(np.float32)
    logits[..., V:] += 20.0       # the padding bias must hide these columns
    targets = rng.integers(0, V, (2, 4)).astype(np.int32)
    mask = np.ones((2, 4), np.float32)
    mask[:, -1] = 0.0
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(targets), V,
                        jnp.asarray(mask)))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(targets), V,
                              torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=1e-6)
    unpadded = float(cross_entropy(torch.from_numpy(logits[..., :V]),
                                   torch.from_numpy(targets), V,
                                   torch.from_numpy(mask)))
    assert got == pytest.approx(unpadded, rel=1e-6)


@pytest.mark.parametrize("nesterov,wd", [(False, 0.0), (True, 0.01)])
def test_momentum_sgd_vs_jax(nesterov, wd):
    """bf16 and fp32 parameters; the momentum stays fp32 for both."""
    from repro.optim.optimizer import MomentumSGD as JaxSGD
    from repro.optim.optimizer import MomentumSGDConfig as JaxSGDConfig
    rng = np.random.default_rng(4)
    shapes = [(8, 5), (5,), (3, 4, 2)]
    types = ["bfloat16", "float32", "bfloat16"]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(a).astype(getattr(jnp, t)) for a, t in zip(p0, types)]
    tp = [torch.from_numpy(a).to(getattr(torch, t)) for a, t in zip(p0, types)]
    jopt = JaxSGD(JaxSGDConfig(lr=0.1, momentum=0.9, weight_decay=wd,
                               nesterov=nesterov))
    topt = MomentumSGD(MomentumSGDConfig(lr=0.1, momentum=0.9,
                                         weight_decay=wd, nesterov=nesterov))
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jg = [jnp.asarray(a).astype(p.dtype) for a, p in zip(g0, jp)]
        tg = [torch.from_numpy(a).to(p.dtype) for a, p in zip(g0, tp)]
        jp, jstate, jn = jopt.update(jp, jg, jstate)
        _, tstate, tn = topt.update(tp, tg, tstate)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert all(m.dtype == torch.float32 for m in tstate["mu"])
    assert tstate["step"] == int(jstate["step"]) == 3
    for j, t in zip(jp, tp):
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        tol = 1e-2 if t.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(f32(t), f32(j), atol=tol, rtol=tol)
    # both sides fold the same gradients (bf16 ones included) into an fp32
    # momentum, in fp32: equal to within fp32 rounding whatever the type
    for j, t in zip(jstate["mu"], tstate["mu"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    assert float(global_norm(tp)) > 0


@pytest.mark.parametrize("step", [0, 1, 7])
def test_token_pipeline_bit_equal(step):
    from repro.data.pipeline import DataConfig as JaxDataConfig
    from repro.data.pipeline import TokenPipeline as JaxPipeline
    for vocab, seq, batch, seed in ((256, 32, 2, 41), (50304, 64, 4, 0)):
        got = TokenPipeline(DataConfig(vocab, seq, batch, seed=seed)).batch_at(step)
        want = JaxPipeline(JaxDataConfig(vocab, seq, batch, seed=seed)).batch_at(step)
        assert got["tokens"].dtype == want["tokens"].dtype
        assert np.array_equal(got["tokens"], want["tokens"])


def test_loss_vs_jax(carried):
    from repro.models.steps import loss_fn as jax_loss
    dtype, jcfg, jparams, cfg, model = carried
    toks = TokenPipeline(DataConfig(cfg.vocab_size, 32, 2, seed=5)).batch_at(0)
    want, _ = jax_loss(jparams, jcfg, toks)
    got, (ce, aux) = loss_fn(model, cfg, toks)
    assert float(got) == pytest.approx(float(want), rel=TOL[dtype])
    assert float(aux) == 0.0 and float(ce) == float(got)


def test_train_step_losses_vs_jax(carried):
    """Three momentum-SGD steps from the same weights: losses and gradient
    norms in fp32 within 1e-4 relative, in the catalog's bf16 within 2e-2
    (the bf16 gradient norms differ by at most 8.0e-3 relative over these
    steps, the losses by at most 5.9e-4)."""
    from repro.models.steps import make_train_step as jax_train_step
    from repro.optim.optimizer import MomentumSGD as JaxSGD
    from repro.optim.optimizer import MomentumSGDConfig as JaxSGDConfig
    dtype, jcfg, jparams, cfg, _ = carried
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")       # the fixture's stays untouched
    jopt = JaxSGD(JaxSGDConfig(lr=1e-3, momentum=0.9))
    jstate = jopt.init(jparams)
    jstep = jax.jit(jax_train_step(jcfg, jopt))
    opt = MomentumSGD(MomentumSGDConfig(lr=1e-3, momentum=0.9))
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 2, seed=41))
    for i in range(3):
        batch = pipe.batch_at(i)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        model, state, m = step(model, state, batch)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=TOL[dtype]), i
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=TOL[dtype]), i
    assert not any(p.requires_grad for p in model.parameters())


def test_train_mode_refused_for_the_dense_pattern():
    from repro_torch.models import forward
    cfg = get_config("mistral-nemo-12b", smoke=True)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward(model, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                mode="train")
