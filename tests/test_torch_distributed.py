"""The port's multi-device layer in several processes on the CPU (gloo),
against `repro` and against the port on one device: the FSDP x TP train
step, the all-to-all MoE dispatch, decode over head- and sequence-split
caches, the launcher resumed on another mesh, and the SSM mixers over
the model axis.  Each spawn of ranks through tests/_torch_dist.py (one
a test; the train steps' also serves the mixers' test) has its own
timeout, so that a hung collective fails instead of stalling the
suite."""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 180
LOSS_TOL = 2e-4         # tests/test_distribution.py:86
PARAM_TOL = 1e-5
MOE_DENSE_TOL = 1e-4    # tests/test_distribution.py:50-51
MOE_A2A_TOL = 1e-5
DECODE_TOL = 2e-5
MIXER_TOL = 1e-5


def spawn_start(case: str, inp: dict, tmp_path):
    """The case's ranks, started; `spawn_wait` reads their result."""
    inp_path, out_path = tmp_path / f"{case}.pkl", tmp_path / f"{case}.json"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable,
                             os.path.join(HERE, "_torch_dist.py"), case,
                             str(inp_path), str(out_path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    return proc, out_path


def spawn_wait(started) -> dict:
    proc, out_path = started
    jax_wait(proc)
    with open(out_path) as f:
        return json.load(f)


def spawn(case: str, inp: dict, tmp_path) -> dict:
    return spawn_wait(spawn_start(case, inp, tmp_path))


def jax_start(code: str, devices: int) -> subprocess.Popen:
    """`repro` in a child process with `devices` forced host devices
    (tests/test_distribution.py:15-23), started."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def jax_wait(proc: subprocess.Popen) -> str:
    """The child's output, once it has exited 0 (within TIMEOUT)."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    """One spawn of four gloo ranks for the train steps, the launcher and
    the SSM mixers (tests/_torch_dist.py's case_train), with `repro`'s
    one-device losses computed while they run: (the ranks' results,
    `repro`'s loss by arch)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import init_params, make_train_step
    from repro.optim.optimizer import AdamW, AdamWConfig
    tmp_path = tmp_path_factory.mktemp("train")
    train, steps = {}, {}
    # xlstm-350m at one head and B 2: each head spans the ranks of `model`,
    # and some ranks hold no (row, head) cell of the mLSTM
    for arch, over, shape in (("h2o-danube-1.8b", {}, (8, 32)),
                              ("granite-moe-1b-a400m", {}, (8, 32)),
                              ("xlstm-350m", {"num_heads": 1}, (2, 16))):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32, **over)
        key = jax.random.PRNGKey(0)
        params = init_params(key, cfg)
        toks = jax.random.randint(key, shape, 0, cfg.vocab_size)
        steps[arch] = (cfg, params, toks)
        train[arch] = {"params": jax.tree.map(np.asarray, params),
                       "overrides": over,
                       "tokens": np.asarray(toks).astype(np.int64)}
    started = spawn_start("train", {"train": train,
                                    "ckpt_dir": str(tmp_path / "ck")},
                          tmp_path)
    want = {}
    for arch, (cfg, params, toks) in steps.items():
        opt = AdamW(AdamWConfig(lr=1e-3, total_steps=10))
        _, _, m = jax.jit(make_train_step(cfg, opt))(params, opt.init(params),
                                                    {"tokens": toks})
        want[arch] = float(m["loss"])
    return spawn_wait(started), want


def test_sharded_train_step_and_resharded_resume(train_ranks):
    """FSDP x TP on (2, 2) and (1, 4): the loss against `repro` on one
    device at 2e-4 relative, the weights after one AdamW step against the
    port's unsharded step at 1e-5; then `launch.train.run` on (2, 2),
    its step-2 checkpoint restored onto (4, 1), continues to the
    uninterrupted run's losses."""
    res, want = train_ranks
    assert len(want) == 3
    for arch in want:
        for shape in ((2, 2), (1, 4)):
            r = res[f"{arch}/{shape}"]
            rel = abs(r["loss"] - want[arch]) / abs(want[arch])
            assert rel < LOSS_TOL, (arch, shape, r, want[arch])
            assert r["param_diff"] < PARAM_TOL, (arch, shape, r)
    whole, resumed = res["launcher"]["whole"], res["launcher"]["resumed"]
    assert len(whole) == 4 and len(resumed) == 2
    np.testing.assert_allclose(resumed, whole[2:], rtol=LOSS_TOL)


def test_a2a_moe_against_dense_and_repro_a2a(tmp_path):
    """moe_a2a_dispatch on (2, 2) (deepseek-v2-lite-16b SMOKE fp32, as
    tests/test_distribution.py:27-52): at capacity factor 100 against
    `repro`'s dense dispatch, output and input gradient at 1e-4; at 1.25
    (slots dropped) against `repro`'s own a2a on four host devices at
    1e-5."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import moe as JM
    arch = "deepseek-v2-lite-16b"
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=jnp.float32,
                              moe_capacity_factor=100.0)
    key = jax.random.PRNGKey(0)
    p = JM.moe_init(key, cfg, jnp.float32)
    x = jax.random.normal(key, (4, 16, cfg.d_model), jnp.float32)
    yd, _ = JM.moe_dense_dispatch(p, x, cfg)
    gd = jax.grad(lambda x: JM.moe_dense_dispatch(p, x, cfg)[0].sum())(x)
    flat = {"router": p["router"], "w_gate": p["w_gate"], "w_up": p["w_up"],
            "w_down": p["w_down"],
            **{f"shared.{k}": v for k, v in p["shared"].items()}}
    proc = jax_start(f"""
        import jax, jax.numpy as jnp, dataclasses, numpy as np
        from repro.configs import get_config
        from repro.models import moe as M
        from repro.launch.mesh import make_mesh
        from repro.sharding.context import activation_mesh
        cfg = dataclasses.replace(get_config("{arch}", smoke=True),
                                  dtype=jnp.float32)
        key = jax.random.PRNGKey(0)
        p = M.moe_init(key, cfg, jnp.float32)
        x = jax.random.normal(key, (4, 16, cfg.d_model), jnp.float32)
        mesh = make_mesh((2, 2), ("data", "model"))
        with mesh, activation_mesh(mesh):
            y, aux = jax.jit(lambda p, x: M.moe_a2a_dispatch(p, x, cfg,
                                                             1.25))(p, x)
        print(repr(np.asarray(y).tolist()))
    """, devices=4)
    res = spawn("moe", {"arch": arch, "x": np.asarray(x),
                        "moe": {k: np.asarray(v) for k, v in flat.items()}},
                tmp_path)
    y125 = np.asarray(eval(jax_wait(proc).strip().splitlines()[-1]))
    np.testing.assert_allclose(res["100.0"]["y"], np.asarray(yd),
                               atol=MOE_DENSE_TOL, rtol=MOE_DENSE_TOL)
    np.testing.assert_allclose(res["100.0"]["grad"], np.asarray(gd),
                               atol=MOE_DENSE_TOL, rtol=MOE_DENSE_TOL)
    np.testing.assert_allclose(res["1.25"]["y"], y125, atol=MOE_A2A_TOL,
                               rtol=MOE_A2A_TOL)


@pytest.fixture(scope="module")
def decode_ranks(tmp_path_factory):
    """One spawn of two gloo ranks for the decode cases
    (tests/_torch_dist.py's case_decode), with `repro`'s prefill and
    decode on the same meshes run meanwhile: (the ranks' results,
    `repro`'s logits by "arch/mesh")."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import init_params
    tmp_path = tmp_path_factory.mktemp("decode")
    rng = np.random.default_rng(0)
    prefix = 6
    decode = {}
    for arch, over, n in (("h2o-danube-1.8b", {}, 28),
                          ("deepseek-v2-lite-16b", {}, 14),
                          ("xlstm-350m", {"num_heads": 1}, 14)):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32, **over)
        params = init_params(jax.random.PRNGKey(0), cfg)
        decode[arch] = {"params": jax.tree.map(np.asarray, params),
                        "overrides": over,
                        "tokens": rng.integers(0, cfg.vocab_size, (1, n))}
    inp = tmp_path / "repro_decode.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"decode": decode, "prefix": prefix}, f)
    want_path = tmp_path / "repro_decode.npz"
    proc = jax_start(f"""
        import dataclasses, pickle
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_config
        from repro.launch.mesh import make_mesh
        from repro.models import init_cache
        from repro.models.steps import (_copy_prefix_cache,
                                        make_decode_step, make_prefill)
        from repro.sharding.context import activation_mesh
        from repro.sharding.rules import cache_sharding, param_sharding
        with open("{inp}", "rb") as f:
            inp = pickle.load(f)
        S0, res = inp["prefix"], {{}}
        for arch, case in inp["decode"].items():
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype=jnp.float32, **case["overrides"])
            params = jax.tree.map(jnp.asarray, case["params"])
            toks = jnp.asarray(case["tokens"])
            steps = toks.shape[1] - S0
            for shape in ((1, 2), (2, 1)):
                mesh = make_mesh(shape, ("data", "model"))
                with mesh, activation_mesh(mesh):
                    p = jax.tree.map(jax.device_put, params, param_sharding(
                        mesh, params, mode="serve"))
                    logits, pre = jax.jit(make_prefill(cfg))(
                        p, {{"tokens": toks[:, :S0]}})
                    cache = init_cache(cfg, 1, S0 + steps)
                    cache = jax.tree.map(jax.device_put, cache,
                                         cache_sharding(mesh, cache))
                    cache = _copy_prefix_cache(cfg, pre, cache)
                    step = jax.jit(make_decode_step(cfg))
                    outs = [np.asarray(logits)]
                    for i in range(steps):
                        logits, cache = step(p, cache,
                                             toks[:, S0 + i:S0 + i + 1],
                                             jnp.int32(S0 + i))
                        outs.append(np.asarray(logits))
                res[f"{{arch}}/{{shape}}"] = np.stack(outs)
        np.savez("{want_path}", **res)
    """, devices=2)
    res = spawn("decode", {"decode": decode, "prefix": prefix}, tmp_path)
    jax_wait(proc)
    return res, dict(np.load(want_path))


def test_decode_over_split_heads_and_split_sequence(decode_ranks):
    """Prefill and decode through `ops` on (1, 2) (heads over `model`) and
    (2, 1) at B1 (the cache's sequence over `data`, the kernel's partial
    softmaxes merged across ranks), with the plain versions on the CPU, on
    `repro`'s weights in fp32: the logits against `repro`'s own prefill
    and decode on the same mesh (two host devices) and against the
    unsharded port, at 2e-5 of the logits' scale.  h2o-danube-1.8b SMOKE
    decodes 22 steps past its window of 16, so its ring wraps across the
    ranks' slices; deepseek-v2-lite-16b SMOKE takes the MLA route;
    xlstm-350m SMOKE at one head splits that head's mLSTM cell over
    `model`."""
    res, want = decode_ranks
    res = {k: v for k, v in res.items() if k != "bf16"}
    assert len(res) == 6 and sorted(res) == sorted(want)
    for name, r in res.items():
        got, ref = np.asarray(r["logits"]), want[name]
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err < DECODE_TOL, (name, "repro", err)
        assert r["unsharded"] < DECODE_TOL, (name, "unsharded", r)


def test_bf16_decode_rounds_once_over_split_sequence_and_heads(decode_ranks):
    """h2o-danube-1.8b SMOKE in bf16 (`repro`'s weights cast by
    params_from_jax), prefill and decode on (2, 1) and (1, 2): on (2, 1)
    the logits equal the unsharded port's bit for bit (the ranks' partial
    outputs merge in fp32 and round once, as one device's softmax does),
    and on both meshes every cross-rank reduction (the decode merge,
    `w_o` and `w_down`'s row-parallel products, the vocab-split lookup)
    meets chip_smoke's same-inputs bound against the one-device op on the
    same inputs, at every layer.  Not held against `repro`'s jitted run:
    its compiled bf16 keeps some intermediates in fp32 (ROADMAP.md F7),
    which makes that a relative-norm check only; the fp32 cases above
    hold the port to `repro`."""
    res = decode_ranks[0]["bf16"]
    assert res["(2, 1)"]["bitwise"], res["(2, 1)"]["unsharded"]
    for mesh in ("(2, 1)", "(1, 2)"):
        worst = res[mesh]["worst"]
        assert sorted(worst) == ["decode", "lookup", "w_down", "w_o"], worst
        assert res[mesh]["problems"] == [], (mesh, res[mesh]["problems"])
        assert len(res[mesh]["layers"]["decode"]) == 2, res[mesh]["layers"]


def test_same_inputs_check_sees_bf16_partials(decode_ranks):
    """The merge as it was before it rounded once, re-created in the ranks
    (tests/_torch_dist.py's bf16_partials: each rank's partial output of
    the sequence-split decode rounded to bf16 before the merge), fails
    the same-inputs bound on (2, 1) at the decode merge, and only there:
    the check sees a second rounding."""
    r = decode_ranks[0]["bf16"]["(2, 1)/bf16_partials"]
    assert not r["bitwise"]
    assert [p.split(" ")[0] for p in r["problems"]] == ["decode"], r
    assert r["worst"]["decode"]["ulps"] > 1, r["worst"]


def test_ssm_mixers_over_the_model_axis(train_ranks):
    """jamba-1.5-large-398b's Mamba and xlstm-350m's mLSTM (SMOKE fp32, at
    one head) on (1, 4) and (2, 2): the train forward, the
    gradients of sum(y**2) in x and every weight, the final state or
    carry, a second forward from it, and a decode step from a random
    state, against the same mixers on one device at 1e-5.  The mLSTM's one head spans the ranks of
    `model`, and some ranks hold no (row, head) cell."""
    res = train_ranks[0]["mixers"]
    assert len(res) == 4
    for name, err in res.items():
        assert err < MIXER_TOL, (name, err)
