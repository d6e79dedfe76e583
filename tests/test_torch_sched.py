"""The port's scheduling modules against the JAX package's, on the same
numpy inputs: dynamic SM allocation, the interference model, traces, the
mixed error handler, the vectorized SysMonitor, the cached predictor, the
matchers, Algorithm 1's scheduler, the policy registry and the measured
policy.  Host arithmetic is copied operation for operation, so it is held
bit for bit; the predictor's MLP is held within 1e-5."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import dynamic_sm as j_dsm
from repro.core import errors as j_err
from repro.core import interference as j_int
from repro.core import matching as j_match
from repro.core import predictor as j_pred
from repro.core import scheduler as j_sched
from repro.core import sysmonitor as j_mon
from repro.core import traces as j_tr
from repro.profiling import calibrate as j_cal
from repro.profiling.matrix import SpeedMatrix as JaxMatrix
import repro.policies as j_pol
from repro_torch.core import dynamic_sm as t_dsm
from repro_torch.core import errors as t_err
from repro_torch.core import interference as t_int
from repro_torch.core import matching as t_match
from repro_torch.core import predictor as t_pred
from repro_torch.core import scheduler as t_sched
from repro_torch.core import sysmonitor as t_mon
from repro_torch.core import traces as t_tr
from repro_torch.models.convert import mlp_from_jax
from repro_torch.profiling import calibrate as t_cal
from repro_torch.profiling.harness import build_speed_matrix
from repro_torch.profiling.matrix import SpeedMatrix as PortMatrix
import repro_torch.policies as t_pol

from test_torch_sim import NumpyPredictor

PREDICTOR_TOL = 1e-5


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def fleet_arrays(n=64, seed=0):
    """Per-device online/offline profile arrays spanning every service and
    offline model, from each package (numpy inputs from one seed)."""
    rng = np.random.default_rng(seed)
    sidx = np.arange(n) % len(t_tr.SERVICES)
    qps = rng.uniform(1.0, 200.0, n)
    midx = rng.integers(0, len(t_int.OFFLINE_MODEL_PROFILES), n)
    shares = rng.uniform(-0.1, 1.1, n)
    models = tuple(t_int.OFFLINE_MODEL_PROFILES)
    port = (t_int.online_profile_arrays(sidx, qps, t_tr.SERVICES),
            t_int.offline_profile_arrays(midx, models))
    ref = (j_int.online_profile_arrays(sidx, qps, j_tr.SERVICES),
           j_int.offline_profile_arrays(midx, models))
    return port, ref, shares


@pytest.fixture(scope="module")
def matrix_path(tmp_path_factory):
    """One smoke matrix built by the port on the CPU, saved once; each
    package loads it through its own SpeedMatrix (`repro`'s own default
    matrix needs the Pallas flash kernel, which the installed jax cannot
    trace)."""
    path = tmp_path_factory.mktemp("matrix") / "smoke.json"
    build_speed_matrix("smoke", 0, device="cpu").save(str(path))
    return str(path)


# ------------------------------------------------------------- dynamic SM
@pytest.mark.parametrize("kw", [{}, dict(headroom=0.0, floor=0.05, cap=0.95,
                                         step=0.05),
                                dict(floor=0.13, cap=0.77, step=0.1),
                                dict(step=0.0)])
def test_dynamic_sm_array_bitwise(kw):
    a = np.concatenate([np.linspace(-0.2, 1.2, 1401),
                        np.random.default_rng(1).uniform(0, 1, 500)])
    got = t_dsm.dynamic_sm_array(a, **kw)
    assert bits_equal(got, j_dsm.dynamic_sm_array(a, **kw))
    for x in a[::37]:
        assert t_dsm.dynamic_sm(x, **kw) == j_dsm.dynamic_sm(x, **kw)
    assert t_dsm.fixed_sm() == j_dsm.fixed_sm() == 0.4
    with pytest.raises(ValueError, match="floor"):
        t_dsm.dynamic_sm_array(a, floor=0.9, cap=0.1)


# ----------------------------------------------------------- interference
def test_interference_arrays_bitwise():
    assert t_int.ONLINE_SERVICE_PROFILES == j_int.ONLINE_SERVICE_PROFILES
    (on, off), (j_on, j_off), shares = fleet_arrays()
    for k in j_on:
        assert bits_equal(on[k], j_on[k]), k
    for k in j_off:
        assert bits_equal(off[k], j_off[k]), k
    for got, want in zip(t_int.shared_performance_arrays(on, off, shares),
                         j_int.shared_performance_arrays(j_on, j_off,
                                                         shares)):
        assert bits_equal(got, want)
    assert bits_equal(
        t_int.instantaneous_sm_demand(on["sm_activity"], on["gpu_util"]),
        j_int.instantaneous_sm_demand(j_on["sm_activity"], j_on["gpu_util"]))
    consts = t_int.online_profile_consts(np.arange(9) % 3, t_tr.SERVICES)
    qps = np.linspace(5.0, 190.0, 9)
    assert all(bits_equal(a, b) for a, b in zip(
        t_int.online_profile_arrays(np.arange(9) % 3, qps, t_tr.SERVICES,
                                    consts=consts).values(),
        j_int.online_profile_arrays(np.arange(9) % 3, qps,
                                    j_tr.SERVICES).values()))


@pytest.mark.parametrize("service", ["recommend", "translate", "vision"])
def test_scalar_interference_equal(service):
    for qps in (0.0, 20.0, 77.7, 190.0, 260.0):
        on, j_on = (t_int.online_profile(service, qps),
                    j_int.online_profile(service, qps))
        assert dataclasses.asdict(on) == dataclasses.asdict(j_on)
        assert t_int.qps_to_activity(qps, 90.0, 0.38) == \
            j_int.qps_to_activity(qps, 90.0, 0.38)
        for name, off in t_int.OFFLINE_MODEL_PROFILES.items():
            j_off = j_int.OFFLINE_MODEL_PROFILES[name]
            for sm in (0.0, 0.1, 0.45, 1.0, 1.3):
                assert t_int.shared_performance(on, off, sm) == \
                    j_int.shared_performance(j_on, j_off, sm)
            for quota in (0.1, 0.4):
                assert t_int.memory_feasible(on, off, quota) == \
                    j_int.memory_feasible(j_on, j_off, quota)


# ----------------------------------------------------------------- traces
@pytest.mark.parametrize("name", ["A", "B", "C", "D"])
def test_make_trace_equal(name):
    for n, horizon, seed in ((16, 3600.0, 0), (50, 4 * 3600.0, 7)):
        got = t_tr.make_trace(name, n, horizon, seed)
        want = j_tr.make_trace(name, n, horizon, seed)
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in want]


def test_qps_bank_rows_bitwise():
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    bank = t_tr.QPSBank([t_tr.OnlineQPS(rng_t) for _ in range(96)])
    ref = j_tr.QPSBank([j_tr.OnlineQPS(rng_j) for _ in range(96)])
    ts = 13.5 + np.arange(40) * 977.0
    assert bits_equal(bank.qps_block(ts), ref.qps_block(ts))
    for t in ts[::7]:
        assert bits_equal(bank.qps(float(t)), ref.qps(float(t)))
    a = t_tr.philly_request_times(np.random.default_rng(2), rate=3.0,
                                  horizon_s=3600.0)
    b = j_tr.philly_request_times(np.random.default_rng(2), rate=3.0,
                                  horizon_s=3600.0)
    assert bits_equal(a, b)


# ----------------------------------------------------------------- errors
def test_error_from_uniform_over_grid():
    thresh = np.cumsum([j_err.ERROR_MIX[k] for k in j_err.ERROR_MIX])
    us = np.concatenate([np.linspace(0.0, 1.0 - 1e-12, 20001),
                         thresh - 1e-12, thresh[:-1], [0.99, 0.994, 0.997]])
    us = np.clip(us, 0.0, 1.0 - 1e-15)
    assert [t_err.error_from_uniform(float(u)).value for u in us] == \
        [j_err.error_from_uniform(float(u)).value for u in us]
    assert {k.value: p for k, p in t_err.ERROR_MIX.items()} == \
        {k.value: p for k, p in j_err.ERROR_MIX.items()}
    rng_t, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    assert [t_err.sample_error(rng_t).value for _ in range(300)] == \
        [j_err.sample_error(rng_j).value for _ in range(300)]


@pytest.mark.parametrize("graceful", [True, False])
@pytest.mark.parametrize("detector", [True, False])
def test_mixed_error_handler_outcomes(graceful, detector):
    h = t_err.MixedErrorHandler(graceful, detector)
    j = j_err.MixedErrorHandler(graceful, detector)
    for kind in t_err.ErrorKind:
        got = h.handle(kind)
        want = j.handle(j_err.ErrorKind(kind.value))
        assert (got.kind.value, got.action.value, got.propagated) == \
            (want.kind.value, want.action.value, want.propagated)
    assert h.propagation_rate() == j.propagation_rate()


# ------------------------------------------------------------- SysMonitor
def test_vector_sysmonitor_state_sequence():
    """A random walk of levels, activity masks and disables: every state
    array equal after every step, ring wrap-around included."""
    rng = np.random.default_rng(3)
    n = 48
    a, b = (t_mon.VectorSysMonitor(n, now=0.0, ring=4),
            j_mon.VectorSysMonitor(n, now=0.0, ring=4))
    t = 0.0
    for step in range(400):
        t += float(rng.choice([1.0, 30.0, 600.0]))
        level = rng.choice([0, 1, 2], n, p=[0.6, 0.2, 0.2]).astype(np.int8)
        active = rng.random(n) < 0.9
        if step == 200:
            a.disable([3, 4])
            b.disable([3, 4])
        assert bits_equal(a.update(level, t, active=active),
                          b.update(level, t, active=active)), step
        for f in ("state", "_readmit_at", "_ol_times", "_ol_ptr"):
            assert bits_equal(getattr(a, f), getattr(b, f)), (step, f)
    assert bits_equal(a.schedulable, b.schedulable)
    assert [s.value for s in a.states()] == [s.value for s in b.states()]
    util = rng.uniform(0.5, 1.0, n)
    args = (util, util * 0.9, util * 0.95, 1590.0 - 800.0 * util, 60.0)
    assert bits_equal(a.classify(*args), b.classify(*args))
    si = np.arange(0, n, 5)
    assert bits_equal(a.wait_periods(si, t), b.wait_periods(si, t))


# -------------------------------------------------------------- predictor
@pytest.fixture(scope="module")
def carried():
    """`repro`'s MLP per GPU type and the port's holding the same weights."""
    ref = {t: j_pred.mlp_init(jax.random.PRNGKey(i))
           for i, t in enumerate(("T4", "A10"))}
    port = t_pred.SpeedPredictor({
        t: mlp_from_jax(jax.tree.map(np.asarray, p), device="cpu")
        for t, p in ref.items()})
    return port, j_pred.SpeedPredictor(ref)


def test_make_dataset_bitwise():
    got = t_pred.make_dataset(np.random.default_rng(6), n=300)
    want = j_pred.make_dataset(np.random.default_rng(6), n=300)
    assert all(bits_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("quantum", [0.0, 0.02])
def test_cached_predictor_same_values_and_counters(quantum):
    """One inner predictor behind both caches: the quantized hit/miss path
    gives the same values, counters and LRU evictions."""
    inner = NumpyPredictor()
    a = t_pred.CachedSpeedPredictor(inner, quantum=quantum, max_entries=200)
    b = j_pred.CachedSpeedPredictor(inner, quantum=quantum, max_entries=200)
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 1, (150, 9)).astype(np.float32)
    for rnd in range(5):
        rows = np.concatenate([base[rnd * 20:rnd * 20 + 90],
                               rng.uniform(0, 1, (30, 9)).astype(np.float32)])
        for gpu in ("T4", "A10"):
            assert bits_equal(a.predict(gpu, rows), b.predict(gpu, rows))
        assert a.stats() == b.stats(), rnd
    assert bits_equal(a.predict("T4", base[0]), b.predict("T4", base[0]))
    assert a.predict_pair("A10", t_int.online_profile("vision", 40.0),
                          t_int.OFFLINE_MODEL_PROFILES["VGG16"], 0.3) == \
        b.predict_pair("A10", j_int.online_profile("vision", 40.0),
                       j_int.OFFLINE_MODEL_PROFILES["VGG16"], 0.3)


def test_weight_grid_with_carried_predictor(carried):
    """Algorithm 1's weight grid with the MLP carried across: within the
    predictor tolerance, and the same column groups."""
    port, ref = carried
    rng = np.random.default_rng(2)
    n = 50
    gpu = np.array(["T4", "A10", "T4", "T4"] * 13)[:n]
    on_feats = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    shares = t_dsm.dynamic_sm_array(rng.uniform(0, 1, n))
    models = list(t_int.OFFLINE_MODEL_PROFILES)
    picks = rng.integers(0, 4, 30)
    t_jobs = [t_sched.OfflineJob(i, t_int.OFFLINE_MODEL_PROFILES[models[k]],
                                 100.0) for i, k in enumerate(picks)]
    j_jobs = [j_sched.OfflineJob(i, j_int.OFFLINE_MODEL_PROFILES[models[k]],
                                 100.0) for i, k in enumerate(picks)]
    cfg_t, cfg_j = t_sched.SchedulerConfig(), j_sched.SchedulerConfig()
    got, g_grp = t_sched.build_weight_grid_arrays(gpu, on_feats, shares,
                                                  t_jobs, port, cfg_t)
    want, w_grp = j_sched.build_weight_grid_arrays(gpu, on_feats, shares,
                                                   j_jobs, ref, cfg_j)
    assert bits_equal(g_grp, w_grp) and got.shape == want.shape == (n, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=PREDICTOR_TOL)
    assert bits_equal(t_sched.static_weight_grid(shares, t_jobs, cfg_t)[0],
                      j_sched.static_weight_grid(shares, j_jobs, cfg_j)[0])


def test_build_speed_predictor_on_cpu():
    p = t_pred.build_speed_predictor(gpu_types=("T4",), n=200, epochs=3,
                                     device="cpu")
    assert p.params_by_type["T4"][0]["w"].device.type == "cpu"
    out = p.predict("T4", t_pred.make_dataset(np.random.default_rng(0),
                                              n=20)[0])
    assert out.shape == (20,) and np.all((out > 0) & (out < 1))
    assert len(p.histories["T4"]["val_mae"]) == 3


# --------------------------------------------------------------- matching
@pytest.mark.parametrize("shape", [(7, 5), (5, 7), (40, 40), (300, 120)])
def test_km_and_sharded_match_same_pairs(shape):
    rng = np.random.default_rng(sum(shape))
    w = np.round(rng.uniform(0, 1, shape), 2)
    w[rng.random(shape) < 0.2] = 0.0
    assert t_match.km_match(w) == j_match.km_match(w)
    assert t_match.sharded_match(w, shard_size=64) == \
        j_match.sharded_match(w, shard_size=64)
    cost = w.max() - (w if shape[0] <= shape[1] else w.T)
    assert bits_equal(t_match._jv_min_assign(cost),
                      j_match._jv_min_assign(cost))
    pairs = t_match.km_match(w)
    assert t_match.matching_weight(w, pairs) == \
        j_match.matching_weight(w, pairs)


def test_brute_force_and_row_hash_equal():
    w = np.random.default_rng(1).uniform(0, 1, (5, 4))
    assert t_match.brute_force_match(w) == j_match.brute_force_match(w)
    ids = np.arange(0, 10 ** 6, 997)
    assert bits_equal(t_match._stable_row_hash(ids),
                      j_match._stable_row_hash(ids))


def scheduler_instance(rng, n, m, u=4):
    vals = np.round(rng.uniform(0, 1, (n, u)), 2)
    grp = rng.integers(0, u, m)
    ids = np.sort(rng.choice(10 * n, size=n, replace=False))
    return vals, grp, ids


@pytest.mark.parametrize("n,m", [(1500, 600), (300, 700), (40, 30)])
def test_sharded_compact_and_incremental_same_pairs(n, m):
    """Warm and cold incremental rounds give the same pairs as `repro`'s,
    round after round of drifting rows and churning columns."""
    rng = np.random.default_rng(n + m)
    vals, grp, ids = scheduler_instance(rng, n, m)
    assert t_match.sharded_match_compact(vals, grp, shard_size=128) == \
        j_match.sharded_match_compact(vals, grp, shard_size=128)
    warm_t = t_match.IncrementalMatcher(shard_size=128)
    warm_j = j_match.IncrementalMatcher(shard_size=128)
    for rnd in range(4):
        touch = rng.random(n) < 0.02
        vals[touch] = np.round(rng.uniform(0, 1, (int(touch.sum()), 4)), 2)
        grp = np.concatenate([grp[5:], rng.integers(0, 4, 5)])
        got = warm_t.match(vals, grp, ids)
        assert got == warm_j.match(vals, grp, ids), rnd
        assert got == j_match.IncrementalMatcher(shard_size=128).match(
            vals, grp, ids), rnd
    assert warm_t.stats() == warm_j.stats()


# -------------------------------------------------------------- scheduler
@pytest.mark.parametrize("use_matching", [True, False])
@pytest.mark.parametrize("use_dynamic_sm", [True, False])
def test_schedule_same_assignments(use_matching, use_dynamic_sm):
    """Algorithm 1 end to end from slot objects, small (dense KM) and
    sharded (incremental matcher), under one numpy predictor."""
    pred = NumpyPredictor()
    rng = np.random.default_rng(11)
    for n, m, shard in ((24, 30, 256), (400, 300, 64)):
        sidx = np.arange(n) % 3
        on_t = t_int.online_profile_arrays(sidx, rng.uniform(5, 190, n),
                                           t_tr.SERVICES)
        gpu = ["A10" if i % 4 == 3 else "T4" for i in range(n)]
        models = list(t_int.OFFLINE_MODEL_PROFILES)
        picks = rng.integers(0, 4, m)
        kw = dict(use_dynamic_sm=use_dynamic_sm, use_matching=use_matching,
                  shard_size=shard)
        got = t_sched.schedule(
            t_sched.build_online_slots(range(n), gpu, sidx, on_t,
                                       t_tr.SERVICES),
            [t_sched.OfflineJob(i, t_int.OFFLINE_MODEL_PROFILES[models[k]],
                                50.0) for i, k in enumerate(picks)],
            pred, t_sched.SchedulerConfig(**kw),
            matcher=t_match.IncrementalMatcher())
        want = j_sched.schedule(
            j_sched.build_online_slots(range(n), gpu, sidx, on_t,
                                       j_tr.SERVICES),
            [j_sched.OfflineJob(i, j_int.OFFLINE_MODEL_PROFILES[models[k]],
                                50.0) for i, k in enumerate(picks)],
            pred, j_sched.SchedulerConfig(**kw),
            matcher=j_match.IncrementalMatcher())
        assert [dataclasses.astuple(a) for a in got] == \
            [dataclasses.astuple(a) for a in want]
        assert got


# --------------------------------------------------------------- policies
def test_policy_registry_names():
    assert t_pol.available() == j_pol.available()
    assert len(t_pol.available()) == 10
    assert t_pol.resolve("dedicated") is t_pol.resolve("online-only")
    assert t_pol.resolve("calibrated-muxflow") is t_pol.MEASURED_MUXFLOW
    assert t_cal.register_measured_policy() is t_pol.MEASURED_MUXFLOW
    with pytest.raises(ValueError, match="available: muxflow"):
        t_pol.resolve("no-such-policy")


def policy_pair(name, matrix_path):
    if name == "muxflow-measured":
        return (t_cal.MeasuredMuxFlowPolicy(PortMatrix.load(matrix_path)),
                j_cal.MeasuredMuxFlowPolicy(JaxMatrix.load(matrix_path)))
    return t_pol.resolve(name), j_pol.resolve(name)


@pytest.mark.parametrize("name", j_pol.available())
def test_policy_arrays_bitwise(name, matrix_path):
    port, ref = policy_pair(name, matrix_path)
    (on, off), (j_on, j_off), shares = fleet_arrays(seed=2)
    shares = np.clip(shares, 0.0, 1.0)
    for got, want in zip(port.shared_performance(on, off, shares),
                         ref.shared_performance(j_on, j_off, shares)):
        assert bits_equal(got, want)
    idx = np.arange(0, 64, 3)
    assert bits_equal(port.sm_shares(on, idx), ref.sm_shares(j_on, idx))
    got, want = port.scheduler_config(128), ref.scheduler_config(128)
    assert (got is None and want is None) or \
        dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (port.name, port.needs_predictor, port.wants_scheduling) == \
        (ref.name, ref.needs_predictor, ref.wants_scheduling)


def test_default_matrix_and_measured_policy(matrix_path, monkeypatch):
    """`$REPRO_SPEED_MATRIX` loads without a device; without it the matrix
    is built on the device asked for, memoized; the registered policy
    follows the variable."""
    monkeypatch.setenv("REPRO_SPEED_MATRIX", matrix_path)
    loaded = t_cal.default_matrix()
    assert loaded.to_json() == PortMatrix.load(matrix_path).to_json()
    pol = t_pol.MEASURED_MUXFLOW
    assert pol.matrix.to_json() == loaded.to_json()
    monkeypatch.delenv("REPRO_SPEED_MATRIX")
    built = t_cal.default_matrix(device="cpu")
    assert built is t_cal.default_matrix(device="cpu")
    assert built.to_json() == loaded.to_json()
    p = t_cal.MeasuredMuxFlowPolicy(device="cpu")
    assert p.matrix is built and p.provider is p.provider
    pred = p.build_predictor(("T4",), samples=100, epochs=2, device="cpu")
    assert pred.params_by_type["T4"][0]["w"].device.type == "cpu"
