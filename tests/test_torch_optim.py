"""The port's AdamW against `repro.optim.optimizer`: the learning-rate
schedule, global-norm clipping and the update of parameters and moments,
on the same numpy-drawn parameters and gradients."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.optimizer import AdamW as JaxAdamW
from repro.optim.optimizer import AdamWConfig as JaxAdamWConfig
from repro.optim.optimizer import clip_by_global_norm as jax_clip
from repro.optim.optimizer import cosine_lr as jax_cosine_lr
from repro_torch.optim import (AdamW, AdamWConfig, clip_by_global_norm,
                               cosine_lr)

SCHEDULE = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 150])
def test_cosine_lr_matches_jax(step):
    """Steps 0, 1, the end of warm-up, mid-way, the total and beyond."""
    got = cosine_lr(AdamWConfig(**SCHEDULE), step)
    want = jax_cosine_lr(JaxAdamWConfig(**SCHEDULE), jnp.int32(step))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-7, abs=0.0)


def draw(seed: int, scale: float):
    """Parameters and three steps of gradients, drawn in numpy fp32."""
    rng = np.random.default_rng(seed)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[scale * rng.standard_normal(s).astype(np.float32)
              for s in shapes] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_clip_by_global_norm_matches_jax(clip):
    _, grads = draw(0, 1.0 if clip == "active" else 0.01)
    got, gnorm = clip_by_global_norm([torch.from_numpy(g) for g in grads[0]],
                                     1.0)
    want, jnorm = jax_clip([jnp.asarray(g) for g in grads[0]], 1.0)
    assert (float(gnorm) > 1.0) == (clip == "active")
    assert float(gnorm) == pytest.approx(float(jnorm), rel=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, clip, master):
    """Three updates with weight decay on, the clip active (global norm
    above 1) or not: fp32 parameters and the moments within 1e-6, bf16
    parameters within one bf16 ulp."""
    params, grads = draw(1, 1.0 if clip == "active" else 0.01)
    acfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
                master_weights=master)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    jopt = JaxAdamW(JaxAdamWConfig(**acfg))
    jparams = [jnp.asarray(p, jt) for p in params]
    jstate = jopt.init(jparams)
    opt = AdamW(AdamWConfig(**acfg))
    tparams = [torch.from_numpy(p).to(tt) for p in params]
    state = opt.init(tparams)
    for step_grads in grads:
        jg = [jnp.asarray(g, jt) for g in step_grads]
        tg = [torch.from_numpy(g).to(tt) for g in step_grads]
        assert (float(np.sqrt(sum((np.asarray(g, np.float32) ** 2).sum()
                                  for g in jg))) > 1.0) == (clip == "active")
        jparams, jstate, jnorm = jopt.update(jparams, jg, jstate)
        out, state, gnorm = opt.update(tparams, tg, state)
        assert all(a is b for a, b in zip(out, tparams))      # in place
        assert float(gnorm) == pytest.approx(float(jnorm), rel=1e-6)
    for got, want in zip(tparams, jparams):
        assert got.dtype == tt
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert (np.abs(got - want) <= bf16_ulp(want)).all()
    for key in ("m", "v") + (("master",) if master else ()):
        for got, want in zip(state[key], jstate[key]):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
