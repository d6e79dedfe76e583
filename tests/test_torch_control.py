"""The port's control plane against the JAX package's.

Every scenario of `cluster/scenario.py` runs through both packages'
`run_scenario` under one deterministic numpy predictor, at 16-64 devices
for 1-2 h, and the canonical JSON reports (`json.dumps(report, indent=2,
sort_keys=True)`, the CLI's bytes) must be equal: tolerance 0.  The same
holds for `calibrated` over one saved speed matrix (`REPRO_SPEED_MATRIX`,
which both packages honour), for the front door's stdout on policies that
train no predictor, for the torch tick engine against the numpy one, and
for the arrival processes and the autoscaler.  The JAX package is imported
inside the tests that compare with it, so the `cuda` case also runs on a
machine without jax."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import cli
from repro_torch.cluster import control as t_ctl
from repro_torch.cluster.scenario import SCENARIOS
from repro_torch.core import simulator as t_sim
from repro_torch.profiling import calibrate as t_cal
from repro_torch.profiling.harness import build_speed_matrix

from _numpy_predictor import NumpyPredictor

SMALL = dict(n_devices=32, hours=1.0, tick_s=60.0)
# chaos-storm's episodes close by 5400 s: its own 2 h lets every fault pair
# with its recovery
SIZES = {"chaos-storm": dict(n_devices=48, hours=2.0, tick_s=60.0)}
TINY = dict(n_devices=16, horizon_s=3600.0, tick_s=60.0, trace="B", seed=5)


def canon(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True)


@pytest.fixture(scope="module")
def predictor():
    return NumpyPredictor()


@pytest.fixture(scope="module")
def matrix_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("matrix") / "smoke.json"
    build_speed_matrix("smoke", 0, device="cpu").save(str(path))
    return str(path)


# ------------------------------------------------- the port against repro
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_report_equals_repro(name, predictor, matrix_path,
                                      monkeypatch):
    from repro.cluster import control as j_ctl
    monkeypatch.setenv("REPRO_SPEED_MATRIX", matrix_path)
    size = SIZES.get(name, SMALL)
    want = j_ctl.run_scenario(name, predictor=predictor, **size)
    got = t_ctl.run_scenario(name, predictor=predictor, device="cpu", **size)
    assert canon(got) == canon(want)
    assert t_ctl.check_schema(got) == [] and j_ctl.check_schema(got) == []
    assert got["obs"] is None and got["incidents"] is None
    assert got["sim"]["n_jobs"] > 0
    if name == "chaos-storm":
        res = got["resilience"]
        assert res["injected"] > 0 and res["unmatched"] == 0


def test_calibrated_builds_its_matrix_on_the_device(predictor, monkeypatch):
    """Without `REPRO_SPEED_MATRIX`, `calibrated` builds its matrix on the
    run's device: here the CPU, giving the report of that matrix pinned."""
    monkeypatch.delenv("REPRO_SPEED_MATRIX", raising=False)
    pinned = t_cal.MeasuredMuxFlowPolicy(
        matrix=build_speed_matrix("smoke", 0, device="cpu"))
    want = t_ctl.run_scenario(
        SCENARIOS["calibrated"].with_overrides(policy=pinned),
        predictor=predictor, device="cpu", **SMALL)
    got = t_ctl.run_scenario("calibrated", predictor=predictor, device="cpu",
                             **SMALL)
    assert canon(got) == canon(want)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_policy_scenario_equals_run_policy(engine, predictor):
    from repro.cluster import control as j_ctl
    got = t_ctl.run_policy_scenario("muxflow", predictor, device="cpu",
                                    engine=engine, **TINY)
    want = t_sim.run_policy("muxflow", predictor, engine=engine,
                            device="cpu", **TINY)
    ref = j_ctl.run_policy_scenario("muxflow", predictor, **TINY)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.n_finished > 0


@pytest.mark.parametrize("name", ["smoke", "serving-slo", "chaos-storm"])
def test_engines_give_equal_reports(name, predictor):
    size = SIZES.get(name, SMALL)
    want = t_ctl.run_scenario(name, predictor=predictor, engine="numpy",
                              **size)
    got = t_ctl.run_scenario(name, predictor=predictor, engine="torch",
                             device="cpu", **size)
    assert canon(got) == canon(want)


def test_obs_is_accepted_and_neutral_to_the_report(predictor, tmp_path):
    from repro_torch.obs import ObsConfig
    obs = ObsConfig(metrics_out=str(tmp_path / "m.jsonl"),
                    alerts_out=str(tmp_path / "i.jsonl"))
    on = t_ctl.run_scenario("smoke", predictor=predictor, device="cpu",
                            obs=obs, **SMALL)
    off = t_ctl.run_scenario("smoke", predictor=predictor, device="cpu",
                             **SMALL)
    assert on["obs"]["metrics"]["rows"] > 0 and on["incidents"] is not None
    assert t_ctl.check_schema(on) == []
    on.update(obs=None, incidents=None)
    assert canon(on) == canon(off)


# ----------------------------------------- arrivals and the autoscaler
def arrivals(pkg, kind: str):
    """One process of `kind` from package `pkg`'s ArrivalProcess."""
    ap = pkg.ArrivalProcess
    if kind == "poisson":
        return ap.poisson(40.0, seed=3)
    if kind == "diurnal":
        return ap.diurnal(lambda t: 30.0 + 20.0 * np.sin(t / 50.0), seed=4)
    if kind == "burst":
        return ap.burst(25.0, mult=4.0, period_s=60.0, burst_len_s=10.0,
                        seed=5)
    times = np.random.default_rng(6).uniform(0.0, 120.0, 500)
    return ap.trace_replay(times)


@pytest.mark.parametrize("kind", ["poisson", "diurnal", "trace-replay",
                                  "burst"])
def test_arrivals_equal_repro(kind):
    from repro.serving_plane import arrivals as j_arr
    from repro_torch.serving_plane import arrivals as t_arr
    assert t_arr.ARRIVAL_KINDS == j_arr.ARRIVAL_KINDS
    got, want = arrivals(t_arr, kind), arrivals(j_arr, kind)
    np.testing.assert_array_equal(got.times(120.0), want.times(120.0))
    np.testing.assert_array_equal(got.first_n(50), want.first_n(50))
    ticks = np.arange(0.0, 120.0, 7.5)
    assert ([got.counts_at(t, 7.5) for t in ticks]
            == [want.counts_at(t, 7.5) for t in ticks])
    assert [got.rate(t) for t in ticks] == [want.rate(t) for t in ticks]
    assert (t_arr.expected_count(got, 120.0)
            == j_arr.expected_count(want, 120.0))


def test_autoscaler_decisions_equal_repro():
    from repro.core import autoscaler as j_as
    from repro_torch.core import autoscaler as t_as
    t = np.arange(0.0, 6 * 3600.0, 30.0)
    qps = 400.0 + 350.0 * np.sin(t / 3000.0) + np.random.default_rng(
        0).normal(0.0, 40.0, t.size)
    out = []
    for mod in (t_as, j_as):
        scaler = mod.Autoscaler(mod.AutoscalerConfig(min_replicas=2,
                                                     max_replicas=40),
                                replicas=10, qps_capacity_per_replica=50.0)
        out.append([(now, dataclasses.asdict(d)) for now, q in zip(t, qps)
                    if (d := scaler.observe(float(q), float(now)))])
    assert out[0] == out[1]
    assert len(out[0]) > 4


# ------------------------------------------------------------ the front door
FRONT = ["--devices", "24", "--hours", "1"]


@pytest.mark.parametrize("name", ["mig-partition", "tally-slice"])
def test_cli_sim_stdout_equals_repro(name, capsys):
    from repro import cli as j_cli
    assert j_cli.main(["sim", "--scenario", name, *FRONT]) == 0
    want = capsys.readouterr().out
    assert cli.main(["sim", "--device", "cpu", "--scenario", name,
                     *FRONT]) == 0
    got = capsys.readouterr()
    assert got.out == want
    assert "torch engine on cpu" in got.err


@pytest.mark.parametrize("command", ["sim", "serve"])
def test_cli_check_schema(command, tmp_path, capsys):
    path = tmp_path / "report.json"
    assert cli.main([command, "--device", "cpu", "--engine", "numpy",
                     "--scenario", "serving-slo", *FRONT,
                     "--out", str(path)]) == 0
    report = json.loads(path.read_text())
    assert report["serving"]["total"]["arrived"] > 0
    assert cli.main([command, "--check-schema", str(path)]) == 0
    assert "schema OK" in capsys.readouterr().err
    del report["resilience"]
    path.write_text(json.dumps(report))
    assert cli.main([command, "--check-schema", str(path)]) == 1
    assert "missing top-level key 'resilience'" in capsys.readouterr().err


@pytest.mark.parametrize("command", ["sim", "serve"])
def test_cli_refuses_to_run_without_a_card(command, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([command, "--scenario", "mig-partition", *FRONT])
    metrics = tmp_path / "m.jsonl"
    assert cli.main([command, "--device", "cpu", "--scenario",
                     "mig-partition", *FRONT, "--metrics-out",
                     str(metrics)]) == 0
    assert metrics.read_text().startswith('{"kind":"header"')


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_smoke_on_the_card_equals_numpy(predictor):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want = t_ctl.run_scenario("smoke", predictor=predictor, engine="numpy",
                              device="cuda")
    got = t_ctl.run_scenario("smoke", predictor=predictor, engine="torch",
                             device="cuda")
    assert canon(got) == canon(want)
    assert t_ctl.check_schema(got) == []
