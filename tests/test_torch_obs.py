"""The port's observability plane against the JAX package's.

Under one deterministic numpy predictor, at 32-48 devices for 1-2 h, the
report and the four obs artifacts (metrics JSONL, trace JSONL, Prometheus
text, incidents JSONL) of `repro_torch` must be equal byte for byte to
`repro`'s, and across the port's two tick engines: tolerance 0.  Turning
obs on changes no byte of the report outside its own `obs` and `incidents`
sections, alerting changes no byte of the metrics stream, and the phase
profiler's wall clock never reaches an artifact.  The JAX package is
imported inside the tests that compare with it."""
import json

import pytest

import repro_torch.obs as t_obs
from repro_torch.cluster import control as t_ctl
from repro_torch.obs import ObsConfig, lint_prometheus

from _numpy_predictor import NumpyPredictor

SMALL = dict(n_devices=32, hours=1.0, tick_s=60.0)
# chaos-storm's episodes close by 5400 s: its own 2 h lets every fault pair
# with its recovery
SIZES = {"chaos-storm": dict(n_devices=48, hours=2.0, tick_s=60.0)}
FILES = ("metrics.jsonl", "trace.jsonl", "metrics.prom", "incidents.jsonl")


def canon(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True)


def full_obs(pkg, d, **kw) -> object:
    """Every output of `pkg`'s ObsConfig, into directory `d`."""
    d.mkdir(parents=True, exist_ok=True)
    args = dict(metrics_out=str(d / "metrics.jsonl"),
                trace_out=str(d / "trace.jsonl"),
                prom_out=str(d / "metrics.prom"),
                alerts_out=str(d / "incidents.jsonl"),
                metrics_every_s=300.0)
    args.update(kw)
    return pkg.ObsConfig(**args)


def artifacts(d) -> dict:
    return {f: (d / f).read_bytes() for f in FILES if (d / f).exists()}


@pytest.fixture(scope="module")
def predictor():
    return NumpyPredictor()


# ------------------------------------------------- the port against repro
@pytest.mark.parametrize("name", ["smoke", "serving-slo", "fault-storm",
                                  "chaos-storm"])
def test_obs_artifacts_equal_repro(name, predictor, tmp_path):
    import repro.obs as j_obs
    from repro.cluster import control as j_ctl
    size = SIZES.get(name, SMALL)
    want = j_ctl.run_scenario(name, predictor=predictor,
                              obs=full_obs(j_obs, tmp_path / "j"), **size)
    got = t_ctl.run_scenario(name, predictor=predictor, device="cpu",
                             obs=full_obs(t_obs, tmp_path / "t"), **size)
    assert canon(got) == canon(want)
    assert t_ctl.check_schema(got) == [] and j_ctl.check_schema(got) == []
    a, b = artifacts(tmp_path / "t"), artifacts(tmp_path / "j")
    assert sorted(a) == sorted(FILES)
    assert a == b
    assert lint_prometheus(a["metrics.prom"].decode()) == []
    assert got["obs"]["metrics"]["windows"] >= 4
    assert got["incidents"]["windows"] == got["obs"]["metrics"]["windows"]


def test_check_schema_reads_obs_and_incidents_as_repro_does(predictor,
                                                           tmp_path):
    """A report with `obs` and `incidents` sections gets repro's problem
    list from the port's check_schema (the schema strings live in
    obs/plane.py and obs/alerts.py and are imported by the control plane),
    for a good report and for damaged ones."""
    from repro.cluster import control as j_ctl
    rep = t_ctl.run_scenario("smoke", predictor=predictor, device="cpu",
                             obs=full_obs(t_obs, tmp_path), **SMALL)
    bad_obs = json.loads(canon(rep))
    bad_obs["obs"]["schema"] = "repro.obs/v0"
    del bad_obs["obs"]["trace"]
    del bad_obs["obs"]["metrics"]["digest"]
    bad_inc = json.loads(canon(rep))
    bad_inc["incidents"]["schema"] = None
    for report in (rep, bad_obs, bad_inc, {"obs": {"schema": "x"}}):
        assert t_ctl.check_schema(report) == j_ctl.check_schema(report)
    assert t_ctl.check_schema(rep) == []
    assert len(t_ctl.check_schema(bad_obs)) >= 3


# -------------------------------------------------- across the port's engines
@pytest.mark.parametrize("name", ["serving-slo", "fault-storm"])
def test_obs_artifacts_equal_across_engines(name, predictor, tmp_path):
    reps = {}
    for engine in ("numpy", "torch"):
        reps[engine] = t_ctl.run_scenario(
            name, predictor=predictor, device="cpu", engine=engine,
            obs=full_obs(t_obs, tmp_path / engine), **SMALL)
    assert canon(reps["torch"]) == canon(reps["numpy"])
    assert (artifacts(tmp_path / "torch")
            == artifacts(tmp_path / "numpy"))


def test_obs_is_neutral_to_the_report(predictor, tmp_path):
    """Every obs output on the torch engine, under fault-storm's failures,
    repairs and evictions, moves no byte of the report outside its own
    sections."""
    off = t_ctl.run_scenario("fault-storm", predictor=predictor,
                             device="cpu", engine="torch", **SMALL)
    on = t_ctl.run_scenario("fault-storm", predictor=predictor,
                            device="cpu", engine="torch",
                            obs=full_obs(t_obs, tmp_path), **SMALL)
    assert off["obs"] is None and off["incidents"] is None
    assert on["obs"] is not None and on["incidents"] is not None
    strip = ("obs", "incidents")
    assert (canon({k: v for k, v in on.items() if k not in strip})
            == canon({k: v for k, v in off.items() if k not in strip}))


def test_metrics_bytes_unchanged_by_alerting(predictor, tmp_path):
    m = {}
    for tag, alerts in (("on", str(tmp_path / "inc.jsonl")), ("off", None)):
        out = tmp_path / f"m-{tag}.jsonl"
        rep = t_ctl.run_scenario(
            "fault-storm", predictor=predictor, device="cpu",
            obs=ObsConfig(metrics_out=str(out), alerts_out=alerts,
                          metrics_every_s=300.0), **SMALL)
        m[tag] = (out.read_bytes(), rep["obs"]["metrics"]["digest"])
    assert m["on"] == m["off"]


def test_profile_phases_never_lands_in_report(predictor, tmp_path, capsys):
    obs = ObsConfig(metrics_out=str(tmp_path / "m.jsonl"),
                    profile_phases=True)
    rep = t_ctl.run_scenario("smoke", predictor=predictor, device="cpu",
                             engine="torch", obs=obs, **SMALL)
    assert rep["obs"]["profile_phases"] is True
    assert "wall_s" not in json.dumps(rep)
    assert "[phases] dense_core" in capsys.readouterr().err
    rep_off = t_ctl.run_scenario("smoke", predictor=predictor, device="cpu",
                                 **SMALL)
    on = {k: v for k, v in rep.items() if k != "obs"}
    off = {k: v for k, v in rep_off.items() if k != "obs"}
    assert canon(on) == canon(off)


# ------------------------------------------------------- the building blocks
def test_exporters_equal_repro(tmp_path):
    """canonical_json, the JSONL writer's bytes and running digest, and the
    Prometheus text of one registry are repro's."""
    import repro.obs as j_obs
    doc = {"b": [1.0 / 3.0, 2, None], "a": {"x": 1e-9, "y": "s"},
           "c": 123456.789012345}
    assert t_obs.canonical_json(doc) == j_obs.canonical_json(doc)
    texts, digests = [], []
    for pkg, tag in ((t_obs, "t"), (j_obs, "j")):
        w = pkg.JsonlWriter(str(tmp_path / f"{tag}.jsonl"))
        for i in range(5):
            w.write({"kind": "sample", "t": 60.0 * i, "v": i / 7.0})
        w.close()
        digests.append(w.digest())
        reg = pkg.MetricsRegistry()
        reg.counter("jobs_total", "jobs", ("pool",)).labels(pool="a").inc(3)
        reg.gauge("util", "u").set(0.25)
        h = reg.histogram("lat", "l", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        texts.append(pkg.prometheus_text(reg))
    assert digests[0] == digests[1]
    assert ((tmp_path / "t.jsonl").read_bytes()
            == (tmp_path / "j.jsonl").read_bytes())
    assert texts[0] == texts[1]
    assert t_obs.lint_prometheus(texts[0]) == []


def test_alert_catalog_equals_repro():
    import repro.obs as j_obs
    assert t_obs.alert_rules_available() == j_obs.alert_rules_available()
    for a, b in zip(t_obs.default_alert_rules(), j_obs.default_alert_rules()):
        assert repr(a) == repr(b)
    assert t_obs.ObsConfig.__dataclass_fields__.keys() == (
        j_obs.ObsConfig.__dataclass_fields__.keys())
    for name in ("OBS_SCHEMA", "METRICS_SCHEMA", "TRACE_SCHEMA",
                 "ALERTS_SCHEMA", "PHASES"):
        assert getattr(t_obs, name) == getattr(j_obs, name)
