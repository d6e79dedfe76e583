"""The port's per-device reference engine (`core/simulator_legacy.py`).

Against `repro`'s: the same SimConfig and the same numpy predictor give
SimResults equal field for field, timelines included (tolerance 0: both
sides are the same numpy code, so any difference is a port fault).  Then
the port's vectorized `ClusterSim`, on the numpy and the torch (CPU) tick
engines, against the port's legacy engine with `tests/test_sim_parity.py`'s
configuration and rule: counts equal, floats rel 1e-9 / abs 1e-12, p99 rel
0.02 / abs 0.2 (histogram-binned against interpolated), timelines rel 1e-9.
Full horizon (4 h of 30 s ticks at 50 devices), as the parity test's."""
import dataclasses
import functools

import pytest

from repro_torch.core.simulator import ClusterSim, SimConfig
from repro_torch.core.simulator_legacy import LegacyClusterSim
from repro_torch.policies import resolve

from _numpy_predictor import NumpyPredictor

CFG = dict(n_devices=50, horizon_s=4 * 3600.0, tick_s=30.0, trace="B",
           seed=12345)
# test_sim_parity.py's seven policies, then its failure-heavy and
# busier-trace cases
CASES = {
    **{p: (p, {}) for p in ("muxflow", "muxflow-s", "muxflow-m",
                            "muxflow-s-m", "time-sharing",
                            "pb-time-sharing", "online-only")},
    "heavy-failures": ("muxflow", dict(
        device_mtbf_h=3.0, device_repair_s=600.0,
        error_rate_per_job_hour=0.8, graceful_exit=False, seed=7)),
    "busier-trace": ("muxflow", dict(trace="D", seed=3)),
}
_FLOAT_FIELDS = ("avg_latency_ms", "base_avg_latency_ms", "avg_slowdown",
                 "gpu_util", "sm_activity", "mem_used", "avg_norm_tput",
                 "oversold_gpu", "avg_jct_s", "makespan_s", "eviction_frac")
_COUNT_FIELDS = ("n_jobs", "n_finished", "evictions", "errors_injected",
                 "errors_propagated", "online_incidents")
PREDICTOR = NumpyPredictor()


def _predictor(policy):
    return PREDICTOR if resolve(policy).needs_predictor else None


@functools.lru_cache(maxsize=None)
def _legacy(case: str):
    policy, over = CASES[case]
    return LegacyClusterSim(SimConfig(policy=policy, **{**CFG, **over}),
                            _predictor(policy)).run()


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_engine_equals_repro(case):
    from repro.core.simulator import SimConfig as JSimConfig
    from repro.core.simulator_legacy import LegacyClusterSim as JLegacy
    policy, over = CASES[case]
    want = JLegacy(JSimConfig(policy=policy, **{**CFG, **over}),
                   _predictor(policy)).run()
    got = _legacy(case)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.timeline["t"] and got.n_jobs > 0


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vectorized_engines_match_the_legacy_engine(case, engine):
    policy, over = CASES[case]
    vec = ClusterSim(SimConfig(policy=policy, engine=engine, device="cpu",
                               **{**CFG, **over}), _predictor(policy)).run()
    ref = _legacy(case)
    if case == "heavy-failures":
        assert vec.errors_injected > 0
    if case == "busier-trace":
        assert vec.n_finished > 0
    for f in _COUNT_FIELDS:
        assert getattr(vec, f) == getattr(ref, f), f
    for f in _FLOAT_FIELDS:
        assert getattr(vec, f) == pytest.approx(getattr(ref, f), rel=1e-9,
                                                abs=1e-12), f
    assert vec.p99_latency_ms == pytest.approx(ref.p99_latency_ms, rel=0.02,
                                               abs=0.2)
    assert vec.timeline["t"] == ref.timeline["t"]
    for k in ("gpu_util", "sm_act", "mem", "slowdown", "tput"):
        assert vec.timeline[k] == pytest.approx(ref.timeline[k], rel=1e-9)


def test_legacy_engine_refuses_what_it_does_not_model():
    with pytest.raises(ValueError, match="reference engine implements only"):
        LegacyClusterSim(SimConfig(policy="tally-priority", n_devices=4))
    with pytest.raises(ValueError, match="needs a speed predictor"):
        LegacyClusterSim(SimConfig(policy="muxflow", n_devices=4))
