"""jamba-1.5-large-398b's whole SMOKE model against the JAX package in the
modes that compile `repro`'s longest programs, at 8 and 16 layers (one
and two repeats of the super-block): greedy generation, AdamW train steps
and the serving engine under slot reuse.  The rest of the slice's tests
are in tests/test_torch_jamba.py, whose carried weights these share."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import steps as JS
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeRequest as JaxServeRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import greedy_generate, make_train_step
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.serving.engine import EngineConfig, ServeRequest, ServingEngine
from test_torch_jamba import LAYERS, carry, serve, tokens


@pytest.mark.parametrize("layers", LAYERS)
def test_greedy_generate_matches_jax(layers):
    """Prefill (the scan's h_last and the conv window into the decode
    cache), then 10 steps at one position."""
    jcfg, jparams, cfg, model = carry(layers=layers)
    toks = tokens(cfg, 2, 20, seed=6)
    want = JS.greedy_generate(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              10)
    got = greedy_generate(cfg, model, {"tokens": torch.from_numpy(toks)}, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layers", LAYERS)
def test_adamw_train_steps_match_jax(layers):
    """Two AdamW steps from the same weights: each step's loss, ce, moe_aux
    and gradient norm within 1e-4 relative (the second step's loss is that
    of the updated weights)."""
    from repro.optim.optimizer import AdamW as JaxAdamW
    from repro.optim.optimizer import AdamWConfig as JaxAdamWConfig
    jcfg, jparams, cfg, _ = carry(layers=layers)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")       # the cached one stays as it is
    acfg = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jopt = JaxAdamW(JaxAdamWConfig(**acfg))
    jstate = jopt.init(jparams)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    opt = AdamW(AdamWConfig(**acfg))
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 2, seed=41))
    for i in range(2):
        batch = pipe.batch_at(i)
        jp, jstate, jm = jstep(jparams, jstate, batch)
        jparams = jp
        model, state, m = step(model, state, batch)
        for key in ("loss", "ce", "moe_aux", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm[key]),
                                                  rel=1e-4), (i, key)
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("layers", LAYERS)
def test_engine_serves_jamba_like_jax(layers):
    """Seven ragged requests through three slots (slots freed and reused,
    the Mamba state not reset, F5): the same tokens and steps as
    `repro`'s engine."""
    jcfg, jparams, cfg, model = carry(layers=layers)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 10)))
               for _ in range(7)]
    new = [int(rng.integers(2, 7)) for _ in range(7)]
    jeng, want = serve(JaxServeRequest, JaxServingEngine(
        jcfg, jparams, JaxEngineConfig(num_slots=3, kv_capacity=32)),
        prompts, new)
    eng, got = serve(ServeRequest, ServingEngine(
        cfg, model, EngineConfig(num_slots=3, kv_capacity=32)), prompts, new)
    assert got == want and eng.steps == jeng.steps
    assert [len(o) for o in got] == new
