"""The port's measurement loop against the JAX package: arrivals, the
SysMonitor, the workload catalog's declared counts and step functions, the
speed-matrix artifact byte for byte, calibration and the `profile` CLI.

`repro`'s own matrix cannot be built on the installed jax (its Pallas flash
kernel does not trace), so the byte-for-byte comparison runs both harnesses
over a test-local catalog whose steps return a constant: the grid is driven
by the cost model, and only the checksums depend on execution."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.protection import DeviceTelemetry
from repro_torch.core.sysmonitor import SysMonitor, SysMonitorConfig
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.profiling import calibrate, harness, matrix, workloads
from repro_torch.serving_plane import ArrivalProcess

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.mark.parametrize("mean_gap,seed", [
    (2.5, 0), (13.0, [0, 11]), (0.7, [3, 23]), (400.0, 9)])
def test_arrivals_bit_equal(mean_gap, seed):
    from repro.serving_plane import ArrivalProcess as JaxArrivals
    for horizon in (1.0, 4000.0, 16000.0):
        got = ArrivalProcess.poisson(mean_gap=mean_gap, seed=seed).times(horizon)
        want = JaxArrivals.poisson(mean_gap=mean_gap, seed=seed).times(horizon)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sysmonitor_state_sequence_equal():
    from repro.core.protection import DeviceTelemetry as JaxTelemetry
    from repro.core.sysmonitor import SysMonitor as JaxMonitor
    from repro.core.sysmonitor import SysMonitorConfig as JaxConfig
    rng = np.random.default_rng(0)
    kw = dict(init_duration_s=2.0, readmit_base_s=5.0, overlimit_window_s=200.0)
    port, ref = SysMonitor(SysMonitorConfig(**kw)), JaxMonitor(JaxConfig(**kw))
    seen = set()
    for i in range(600):
        now = 0.5 * i
        sample = dict(ts=now, gpu_util=float(rng.uniform(0.5, 1.0)),
                      sm_activity=float(rng.uniform(0.3, 1.0)),
                      sm_clock=float(rng.uniform(850.0, 1600.0)),
                      mem_used_frac=float(rng.uniform(0.3, 1.0)),
                      temp_c=float(rng.uniform(50.0, 95.0)))
        s1, e1 = port.update(DeviceTelemetry(**sample), now)
        s2, e2 = ref.update(JaxTelemetry(**sample), now)
        assert (s1.value, e1) == (s2.value, e2), i
        seen.add(s1.value)
    assert seen == {"init", "healthy", "unhealthy", "overlimit"}


def test_catalog_declares_what_repro_declares():
    from repro.profiling.workloads import build_catalog as jax_catalog
    port, ref = workloads.build_catalog(), jax_catalog()
    assert list(port) == list(ref)
    for name in ref:
        p, r = port[name], ref[name]
        for f in ("role", "seed", "warmup", "steps", "flops_per_step",
                  "bytes_per_step", "mem_bytes", "target_util"):
            assert getattr(p, f) == getattr(r, f), (name, f)
        assert p.cost_s() == r.cost_s()
        assert dataclasses.asdict(p.profile()) == dataclasses.asdict(r.profile())
    assert (workloads.PEAK_FLOPS, workloads.PEAK_BW, workloads.DEVICE_BYTES) \
        == (8.1e12, 300e9, 16 << 30)


def _numpy_normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in shapes]


def test_flash_prefill_step_vs_jax():
    """The catalog's flash step against the JAX oracle on the same inputs
    (the Pallas kernel does not trace on the installed jax)."""
    import jax.numpy as jnp

    from repro.kernels import ref
    B, Sq, H, Hk, d = workloads.FLASH_SHAPE.values()
    q, k, v = _numpy_normal(11, (B, Sq, H, d), (B, Sq, Hk, d), (B, Sq, Hk, d))
    want = ref.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True)
    got = workloads.flash_prefill_step(*map(torch.from_numpy, (q, k, v)))
    # a sum of 32,768 outputs, each within 2e-5 of the oracle
    assert got == pytest.approx(float(jnp.sum(want)), rel=1e-5, abs=1e-3)


def test_decode_serve_step_vs_jax():
    import jax.numpy as jnp

    from repro.kernels.decode_attention import decode_attention
    B, Skv, H, Hk, d, kv_len = workloads.DECODE_SHAPE.values()
    q, k, v = _numpy_normal(23, (B, 1, H, d), (B, Skv, Hk, d), (B, Skv, Hk, d))
    want = decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            kv_len, block_k=128, interpret=True)
    got = workloads.decode_serve_step(*map(torch.from_numpy, (q, k, v)))
    assert got == pytest.approx(float(jnp.sum(want)), rel=1e-5, abs=1e-3)


def test_ssm_scan_step_vs_jax():
    import jax.numpy as jnp

    from repro.kernels.ssm_scan import ssm_scan
    B, S, di, N = workloads.SSM_SHAPE.values()
    z, x, Bc, Cc = _numpy_normal(37, (B, S, di), (B, S, di), (B, S, N),
                                 (B, S, N))
    dt = np.log1p(np.exp(z)).astype(np.float32)
    A_log = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32),
                                   (di, N))).copy()
    arrays = (dt, x, Bc, Cc, A_log)
    want = ssm_scan(*map(jnp.asarray, arrays), chunk=16, interpret=True)
    got = workloads.ssm_scan_step(*map(torch.from_numpy, arrays))
    # a sum of 16,384 outputs, each within 1e-4 of the Pallas kernel
    assert got == pytest.approx(float(jnp.sum(want)), rel=1e-5, abs=1e-2)


def test_lm_train_step_vs_jax():
    """Two catalog train steps (xlstm-350m SMOKE, bf16) from the same
    weights: losses within the bf16 limit, 2e-2."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import DataConfig, TokenPipeline
    from repro.models import init_params as jax_init_params
    from repro.models.steps import make_train_step as jax_train_step
    from repro.optim.optimizer import MomentumSGD, MomentumSGDConfig
    jcfg = jax_get_config("xlstm-350m", smoke=True)
    jparams = jax_init_params(jax.random.PRNGKey(41), jcfg)
    opt = MomentumSGD(MomentumSGDConfig(lr=1e-3, momentum=0.9))
    jstate = opt.init(jparams)
    jstep = jax.jit(jax_train_step(jcfg, opt))
    jpipe = TokenPipeline(DataConfig(jcfg.vocab_size, 32, 2, seed=41))

    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    state = workloads.lm_train_inputs(CPU)
    state["params"] = params_from_jax(jax.tree.map(np.asarray, jparams),
                                      get_config("xlstm-350m", smoke=True),
                                      device="cpu")
    state["opt_state"] = {"mu": [torch.zeros_like(p, dtype=torch.float32)
                                 for p in state["params"].parameters()],
                          "step": 0}
    for i in range(2):
        jparams, jstate, m = jstep(jparams, jstate, jpipe.batch_at(i))
        got = workloads.lm_train_step(state)
        assert got == pytest.approx(float(m["loss"]), rel=2e-2), i
    assert state["i"] == 2


def _constant(catalog):
    """The catalog with every step replaced by one returning 1.0."""
    return {name: dataclasses.replace(w, build=lambda *_: (lambda: 1.0))
            for name, w in catalog.items()}


@pytest.mark.parametrize("suite,seed", [("smoke", 0), ("smoke", 3)])
def test_speed_matrix_byte_equal_to_repro(suite, seed):
    from repro.profiling.harness import SUITES as JAX_SUITES
    from repro.profiling.harness import PairProfiler as JaxProfiler
    from repro.profiling.matrix import SpeedMatrix as JaxMatrix
    from repro.profiling.workloads import build_catalog as jax_catalog
    jprof = JaxProfiler(JAX_SUITES[suite], seed=seed, interpret=True,
                        catalog=_constant(jax_catalog()))
    want = JaxMatrix.from_run(JAX_SUITES[suite], seed, jprof,
                              *jprof.run()).to_json()
    prof = harness.PairProfiler(harness.SUITES[suite], seed=seed,
                                device="cpu",
                                catalog=_constant(workloads.build_catalog()))
    got = matrix.SpeedMatrix.from_run(harness.SUITES[suite], seed, prof,
                                      *prof.run()).to_json()
    assert got == want


@pytest.fixture(scope="module")
def cpu_matrix():
    return harness.build_speed_matrix("smoke", seed=0, device="cpu")


def test_cpu_matrix_runs_the_catalog(cpu_matrix):
    """The real catalog on the CPU: schema clean, and equal to the
    constant-step matrix in every field but the checksums."""
    assert matrix.check_schema(cpu_matrix.data) == []
    prof = harness.PairProfiler(harness.SUITES["smoke"], seed=0, device="cpu",
                                catalog=_constant(workloads.build_catalog()))
    const = matrix.SpeedMatrix.from_run(harness.SUITES["smoke"], 0, prof,
                                        *prof.run())
    got = json.loads(cpu_matrix.to_json())
    want = json.loads(const.to_json())
    for name, w in want["workloads"].items():
        assert w.pop("checksum") == float(w["steps_executed"])
        assert np.isfinite(got["workloads"][name].pop("checksum"))
    assert got == want


def test_cpu_matrix_is_deterministic(cpu_matrix):
    again = harness.build_speed_matrix("smoke", seed=0, device="cpu")
    assert again.to_json() == cpu_matrix.to_json()


def test_catalog_runs_plain_versions_on_cpu():
    before = (da.launches, fa.launches, ss.launches)
    rec = workloads.execute(workloads.build_catalog()["ssm-scan"], device="cpu")
    assert rec.steps_executed == 3 and np.isfinite(rec.checksum)
    assert (da.launches, fa.launches, ss.launches) == before


def test_calibration_matches_repro(cpu_matrix):
    from repro.profiling import calibrate as jcal
    from repro.profiling.matrix import SpeedMatrix as JaxMatrix
    jm = JaxMatrix(json.loads(json.dumps(cpu_matrix.data)))
    for name in cpu_matrix.workloads:
        assert dataclasses.asdict(calibrate.workload_profile(cpu_matrix, name)) \
            == dataclasses.asdict(jcal.workload_profile(jm, name))
    got = calibrate.make_measured_dataset(cpu_matrix, np.random.default_rng(4),
                                          n=300)
    want = jcal.make_measured_dataset(jm, np.random.default_rng(4), n=300)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    rng = np.random.default_rng(5)
    keys = ("gpu_util", "sm_activity", "mem_bw")
    on = {k: rng.uniform(0, 1, 64) for k in keys}
    off = {k: rng.uniform(0, 1, 64) for k in keys}
    share = rng.uniform(-0.2, 1.2, 64)
    for g, w in zip(calibrate.MeasuredInterferenceProvider(cpu_matrix)(on, off, share),
                    jcal.MeasuredInterferenceProvider(jm)(on, off, share)):
        assert np.array_equal(g, w)


def test_measured_predictor_trains_on_cpu(cpu_matrix):
    pred = calibrate.build_measured_predictor(cpu_matrix, n=200, epochs=3,
                                              device="cpu")
    assert set(pred.params_by_type) == set(pred.histories) == {"T4", "A10"}
    assert all(len(h["val_mae"]) == 3 for h in pred.histories.values())
    on = calibrate.workload_profile(cpu_matrix, "decode-serve")
    off = calibrate.workload_profile(cpu_matrix, "ssm-scan")
    curve = calibrate.predict_share_curve(pred, "T4", on, off,
                                          np.array([0.9, 0.1, 0.5]))
    assert curve[1] <= curve[2] <= curve[0]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch", *args],
                          env=env, capture_output=True, text=True, timeout=300)


def test_profile_cli_on_cpu(cpu_matrix, tmp_path):
    out = tmp_path / "m.json"
    proc = _cli("profile", "--suite", "smoke", "--seed", "0",
                "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    assert out.read_text() == cpu_matrix.to_json()
    assert "[exec] lm-train-step" in proc.stderr
    check = _cli("profile", "--check-schema", str(out))
    assert check.returncode == 0 and "schema OK" in check.stderr
    listing = _cli("profile", "--list")
    assert listing.returncode == 0
    assert [ln.split()[0] for ln in listing.stdout.splitlines()] == \
        list(workloads.build_catalog())


def test_profile_cli_rejects_a_bad_artifact(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "nope"}))
    proc = _cli("profile", "--check-schema", str(bad))
    assert proc.returncode == 1 and "schema FAIL" in proc.stderr
    assert _cli("nosuch").returncode == 2


@pytest.mark.cuda
def test_card_matrix_equals_cpu_matrix(cpu_matrix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = (da.launches, fa.launches, ss.launches)
    card = harness.build_speed_matrix("smoke", seed=0)
    assert all(n > b for n, b in zip((da.launches, fa.launches, ss.launches),
                                     before))
    assert matrix.check_schema(card.data) == []
    got, want = json.loads(card.to_json()), json.loads(cpu_matrix.to_json())
    for name in want["workloads"]:
        g = got["workloads"][name].pop("checksum")
        w = want["workloads"][name].pop("checksum")
        rel = 2e-2 if name == "lm-train-step" else 1e-4
        assert g == pytest.approx(w, rel=rel, abs=1e-3), name
    assert got == want
