"""The port's fleet simulator against the JAX package's, and its torch tick
engine against its numpy core.

Both packages run `run_policy` under one deterministic numpy predictor
(the matching then cannot flip on fp32 noise) and must give equal
SimResults for all ten policies and the same event stream.  The torch
engine (float64, on the CPU here; the `cuda` case runs it on the card) must
be bitwise equal to the numpy core: state in lockstep under heavy faults,
byte-identical SimResults per policy, block and per-tick modes, an inexact
tick.  `repro`'s own compiled engine does not import on the installed jax,
so the numpy core is the reference, as `repro/core/engine_xla.py:18-46`
documents.  The JAX package is imported inside the tests that compare with
it, so the `cuda` case also runs on a machine without jax."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core import simulator as t_sim
from repro_torch.core.simulator import ClusterSim, SimConfig, SimHooks
from repro_torch.profiling import calibrate as t_cal
from repro_torch.profiling.harness import build_speed_matrix
from repro_torch.profiling.matrix import SpeedMatrix as PortMatrix

FAST = dict(n_devices=40, horizon_s=3 * 3600.0, tick_s=60.0, trace="B",
            seed=3)                                  # tests/test_simulator.py
TINY = dict(n_devices=16, horizon_s=3600.0, tick_s=60.0, trace="B",
            seed=5)                                  # tests/test_policies.py
FAULTS = dict(policy="muxflow", n_devices=50, horizon_s=2 * 3600.0,
              trace="D", seed=11, device_mtbf_h=2.0, device_repair_s=300.0,
              error_rate_per_job_hour=1.0, graceful_exit=False)
STATE = ("has_job", "model_idx", "sm_share", "progress", "checkpoint",
         "wall", "duration", "failed_until", "outage_until")
# the ten registered policies (tests/test_torch_sched.py holds the port's
# registry equal to repro's)
POLICIES = ("muxflow", "muxflow-m", "muxflow-measured", "muxflow-s",
            "muxflow-s-m", "online-only", "pb-time-sharing",
            "static-partition", "tally-priority", "time-sharing")


class NumpyPredictor:
    """A deterministic float64 numpy MLP with float32 answers, one per GPU
    type: both packages schedule with the same object, so the matching can
    not flip on one framework's fp32 rounding."""

    def __init__(self, seed: int = 0, gpu_types=("T4", "A10", "A100")):
        rng = np.random.default_rng(seed)
        self.params_by_type = {
            t: (rng.standard_normal((9, 16)), rng.standard_normal(16),
                rng.standard_normal(16)) for t in gpu_types}

    def predict(self, gpu_type, feats):
        w1, b1, w2 = self.params_by_type[gpu_type]
        h = np.maximum(np.asarray(feats, np.float64) @ w1 + b1, 0.0)
        return (1.0 / (1.0 + np.exp(-(h @ w2) / 4.0))).astype(np.float32)


@pytest.fixture(scope="module")
def predictor():
    return NumpyPredictor()


@pytest.fixture(scope="module")
def matrix_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("matrix") / "smoke.json"
    build_speed_matrix("smoke", 0, device="cpu").save(str(path))
    return str(path)


def policies(name, matrix_path):
    """(port policy, repro policy): registry names, but the measured policy
    as instances over one saved matrix."""
    if name == "muxflow-measured":
        from repro.profiling import calibrate as j_cal
        from repro.profiling.matrix import SpeedMatrix as JaxMatrix
        import repro.policies  # noqa: F401  (registers the measured policy)
        return (t_cal.MeasuredMuxFlowPolicy(PortMatrix.load(matrix_path)),
                j_cal.MeasuredMuxFlowPolicy(JaxMatrix.load(matrix_path)))
    return name, name


def canon(res) -> str:
    return json.dumps(dataclasses.asdict(res), sort_keys=True)


# ------------------------------------------------- the port against repro
@pytest.mark.parametrize("name", POLICIES)
def test_run_policy_equals_repro(name, predictor, matrix_path):
    from repro.core import simulator as j_sim
    port, ref = policies(name, matrix_path)
    got = t_sim.run_policy(port, predictor, **FAST)
    want = j_sim.run_policy(ref, predictor, **FAST)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name != "online-only":
        assert got.n_finished > 0


@pytest.mark.parametrize("name", ["muxflow", "muxflow-measured",
                                  "time-sharing"])
def test_tiny_fleet_equals_repro_on_both_engines(name, predictor,
                                                 matrix_path):
    from repro.core import simulator as j_sim
    port, ref = policies(name, matrix_path)
    want = dataclasses.asdict(j_sim.run_policy(ref, predictor, **TINY))
    for engine in ("numpy", "torch"):
        got = t_sim.run_policy(port, predictor, engine=engine, device="cpu",
                               **TINY)
        assert dataclasses.asdict(got) == want, engine


def recorder(base):
    """A SimHooks of either package that records every event, with the
    package-specific objects (specs, handled errors) reduced to values."""

    class Recorder(base):
        def __init__(self):
            self.events = []

        def on_job_start(self, sim, t, device, spec, share):
            self.events.append(("start", t, device, spec.job_id, share))

        def on_job_finish(self, sim, t, device, spec, jct_s, wall_s,
                          progress_s):
            self.events.append(("finish", t, device, spec.job_id, jct_s,
                                wall_s, progress_s))

        def on_job_evict(self, sim, t, device, spec, reason, progress_s,
                         checkpoint_s, requeued):
            self.events.append(("evict", t, device, spec.job_id, reason,
                                progress_s, checkpoint_s, requeued))

        def on_error(self, sim, t, device, handled):
            self.events.append(("error", t, device, handled.kind.value,
                                handled.action.value, handled.propagated))

        def on_device_fail(self, sim, t, device, until):
            self.events.append(("fail", t, device, until))

        def on_schedule(self, sim, t, n_free, n_pending_before, n_assigned,
                        wall_s):
            self.events.append(("schedule", t, n_free, n_pending_before,
                                n_assigned))

        def on_tick_end(self, sim, t, telemetry):
            self.events.append(("tick", t, {k: np.asarray(v).tobytes()
                                            for k, v in telemetry.items()}))

    return Recorder()


def test_hooks_see_the_same_event_stream(predictor):
    from repro.core import simulator as j_sim
    kw = dict(FAULTS, n_devices=30)
    rec_j = recorder(j_sim.SimHooks)
    j_sim.ClusterSim(j_sim.SimConfig(**kw), predictor, hooks=rec_j).run()
    kinds = {e[0] for e in rec_j.events}
    assert {"start", "finish", "evict", "error", "fail", "schedule",
            "tick"} <= kinds
    for engine in ("numpy", "torch"):
        rec_t = recorder(SimHooks)
        ClusterSim(SimConfig(engine=engine, device="cpu", **kw), predictor,
                   hooks=rec_t).run()
        assert rec_t.events == rec_j.events, engine


def test_control_plane_surface_equals_repro(predictor):
    """Between-tick mutations through the control-plane surface (job
    injection, forced errors, external evictions, a schedulability mask,
    pool views) land the same in both packages and on both engines."""
    from repro.core import simulator as j_sim
    from repro.core.errors import ErrorKind as JKind
    from repro.core.traces import OfflineJobSpec as JSpec
    from repro_torch.core.errors import ErrorKind as TKind
    from repro_torch.core.traces import OfflineJobSpec as TSpec

    def drive(sim, spec_cls, kind_cls):
        assert sim.chaos is None
        t, views = 0.0, []
        for k in range(90):
            if k == 10:
                sim.inject_jobs([spec_cls(10_000 + i, t, 1800.0, "VGG16")
                                 for i in range(6)])
            if k == 20:
                mask = np.ones(sim.cfg.n_devices, bool)
                mask[::3] = False
                sim.set_schedulable_mask(mask)
            if k in (35, 50):
                busy = np.flatnonzero(sim.state.has_job)
                handled = sim.force_error(int(busy[0]), t,
                                          kind_cls("mps_server_crash"))
                views.append((handled.action.value, handled.propagated))
                sim.evict_device(int(busy[-1]), t)
            if k == 60:
                sim.set_schedulable_mask(None)
                views.append(sim.pool_view(t))
            t = sim.step(t)
        return dataclasses.asdict(sim.finalize(t)), views

    kw = dict(policy="muxflow", n_devices=24, horizon_s=3 * 3600.0,
              trace="C", seed=2)
    want = drive(j_sim.ClusterSim(j_sim.SimConfig(**kw), predictor), JSpec,
                 JKind)
    for engine in ("numpy", "torch"):
        got = drive(ClusterSim(SimConfig(engine=engine, device="cpu", **kw),
                               predictor), TSpec, TKind)
        assert got == want, engine


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown sharing policy"):
        t_sim.build_sim_config("no-such-policy")
    with pytest.raises(ValueError, match="needs a speed predictor"):
        ClusterSim(SimConfig(policy="muxflow"))
    cfg, pol = t_sim.build_sim_config("dedicated", n_devices=8)
    assert cfg.policy is pol and pol.name == "online-only"


# ---------------------------------------- the torch engine against numpy
def lockstep(cfg_kw, predictor, n_ticks, device="cpu"):
    a = ClusterSim(SimConfig(engine="numpy", **cfg_kw), predictor)
    b = ClusterSim(SimConfig(engine="torch", device=device, **cfg_kw),
                   predictor)
    ta = tb = 0.0
    for k in range(n_ticks):
        ta, tb = a.step(ta), b.step(tb)
        for f in STATE:
            assert np.array_equal(getattr(a.state, f),
                                  getattr(b.state, f)), (k, f)
            assert getattr(a.state, f).dtype == getattr(b.state, f).dtype
        assert np.array_equal(a.monitor.state, b.monitor.state), k
        assert a.monitor.state.dtype == b.monitor.state.dtype
        assert np.array_equal(a.monitor._readmit_at, b.monitor._readmit_at,
                              equal_nan=True), k
        assert np.array_equal(a.monitor._ol_times, b.monitor._ol_times), k
        assert np.array_equal(a.monitor._ol_ptr, b.monitor._ol_ptr), k
        assert [sp.job_id for sp in a.pending] == \
            [sp.job_id for sp in b.pending], k
    return a, b


def test_lockstep_state_bitwise_under_heavy_faults(predictor):
    """Every tick's full state matches bit for bit, through failure, error,
    completion, requeue and monitor-eviction paths."""
    a, b = lockstep(FAULTS, predictor, n_ticks=240)
    assert a.errors_injected > 0 and a.evictions > 0
    assert int((a.monitor._ol_ptr > 0).sum()) > 0
    assert canon(a.finalize(240 * 30.0)) == canon(b.finalize(240 * 30.0))


def test_core_outputs_equal_numpy_core(predictor):
    """The engine's per-tick core dict against `_dense_core_numpy`'s, tick
    by tick: every array bitwise and of the same dtype (`kind_idx` where
    `err` is set: it is mask-scoped), with the engine's two extra masks."""
    a = ClusterSim(SimConfig(engine="numpy", **FAULTS), predictor)
    b = ClusterSim(SimConfig(engine="torch", device="cpu", **FAULTS),
                   predictor)
    seen = {}
    core_a, engine = a._dense_core_numpy, b._torch_engine()
    tick_b = engine.tick
    a._dense_core_numpy = lambda inp: seen.setdefault("a", core_a(inp))
    engine.tick = lambda inp: seen.setdefault("b", tick_b(inp))
    t, n_err = 0.0, 0
    for _ in range(200):
        seen.clear()
        t = a.step(t)
        b.step(t - a.cfg.tick_s)
        ca, cb = seen["a"], seen["b"]
        assert cb.keys() - ca.keys() == {"mon_evict", "start_wait"}
        for k in ca:
            x, y = np.asarray(ca[k]), np.asarray(cb[k])
            if k == "kind_idx":
                x, y = x[ca["err"]], y[ca["err"]]
            assert x.dtype == y.dtype, k
            assert np.array_equal(x, y, equal_nan=True), k
        n_err += int(ca["err"].sum())
    assert n_err > 0


@pytest.mark.parametrize("name", POLICIES)
def test_simresults_byte_identical_per_policy(name, predictor, matrix_path):
    port, _ = policies(name, matrix_path)
    kw = dict(policy=port, n_devices=48, horizon_s=3 * 3600.0, trace="C",
              seed=4)
    r_np = ClusterSim(SimConfig(engine="numpy", **kw), predictor).run()
    r_t = ClusterSim(SimConfig(engine="torch", device="cpu", **kw),
                     predictor).run()
    assert canon(r_np) == canon(r_t)


def test_block_and_per_tick_modes_agree(predictor):
    """run() (tick blocks between rounds) and an externally driven step()
    loop (blocks of one) give identical results."""
    kw = dict(policy="muxflow", n_devices=48, horizon_s=2 * 3600.0,
              trace="B", seed=2, engine="torch", device="cpu")
    sim = ClusterSim(SimConfig(**kw), predictor)
    r_blocks = sim.run()
    assert sim._torch._block_hint > 1
    sim = ClusterSim(SimConfig(**kw), predictor)
    t = 0.0
    for _ in range(int(kw["horizon_s"] / 30.0)):
        t = sim.step(t)
    assert canon(r_blocks) == canon(sim.finalize(t))


def test_engines_agree_with_inexact_tick(predictor):
    """tick_s values that are not exactly representable (0.7) drift in the
    accumulated tick time; the torch run()'s block boundaries replay the
    numpy engine's accumulated-float predicate to stay byte-identical."""
    kw = dict(policy="muxflow", n_devices=32, horizon_s=280.0, tick_s=0.7,
              schedule_interval_s=2.1, trace="C", seed=1)
    r_np = ClusterSim(SimConfig(engine="numpy", **kw), predictor).run()
    r_t = ClusterSim(SimConfig(engine="torch", device="cpu", **kw),
                     predictor).run()
    assert canon(r_np) == canon(r_t)


def test_engine_name_validation():
    with pytest.raises(ValueError, match=r"unknown engine 'xla'.*'numpy', "
                                         r"'torch'"):
        ClusterSim(SimConfig(policy="time-sharing", engine="xla"))


def test_torch_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sim.run_policy("time-sharing", n_devices=8, horizon_s=600.0,
                         engine="torch")
    # no quiet fall-back: the numpy engine does not need a device
    assert t_sim.run_policy("time-sharing", n_devices=8,
                            horizon_s=600.0).n_jobs > 0


@pytest.mark.cuda
def test_torch_engine_on_the_card_equals_numpy(predictor):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, b = lockstep(FAULTS, predictor, n_ticks=240, device=None)
    assert b.device.type == "cuda"
    assert canon(a.finalize(240 * 30.0)) == canon(b.finalize(240 * 30.0))
    kw = dict(policy="muxflow", n_devices=2000, horizon_s=2 * 3600.0,
              trace="B", seed=0)
    assert canon(ClusterSim(SimConfig(engine="numpy", **kw),
                            predictor).run()) == \
        canon(ClusterSim(SimConfig(engine="torch", **kw), predictor).run())
