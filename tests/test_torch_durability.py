"""The port's durability plane, forensics, chaos harness and front door
against the JAX package's.

Under one deterministic numpy predictor, at 24-48 devices for 1-2 h: the
WAL segments and `index.json` of a durable run, its report and obs
artifacts, the `inspect` and `diff` documents, the manifest signature and
the chaos verdict are equal byte for byte to `repro`'s (tolerance 0).  A
run killed mid-campaign and resumed gives the uninterrupted run's bytes on
both WAL backends and both tick engines, also when it dies before its first
snapshot and when its resume dies too.  The JAX package is imported inside
the tests that compare with it, so the `cuda` case also runs on a machine
without jax."""
import gc
import json
import os

import pytest
import torch

import repro_torch.obs as t_obs
from repro_torch import cli
from repro_torch.cluster.control import ControlPlane
from repro_torch.cluster.events import Event, EventKind
from repro_torch.cluster.scenario import scenario_by_name
from repro_torch.durability import (DurableRun, diff_runs, dump_inspection,
                                    inspect_run, open_store, restore_control,
                                    resume_run, run_durable)
from repro_torch.durability.manifest import sign_manifest, verify_manifest
from repro_torch.durability.store import BACKENDS, JsonlEventStore

from _numpy_predictor import NumpyPredictor

PRED = NumpyPredictor()
OBS_FILES = ("metrics.jsonl", "trace.jsonl", "metrics.prom",
             "incidents.jsonl")


def canon(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True)


def storm(engine="numpy", **kw):
    """fault-storm cut to 32 devices for 1 h: failures, repairs and
    evictions drive every branch of the tick core."""
    base = dict(n_devices=32, hours=1.0, tick_s=60.0, seed=0, engine=engine)
    base.update(kw)
    return scenario_by_name("fault-storm").with_overrides(**base)


def obs_for(pkg, d):
    d.mkdir(parents=True, exist_ok=True)
    return pkg.ObsConfig(metrics_out=str(d / "metrics.jsonl"),
                         trace_out=str(d / "trace.jsonl"),
                         prom_out=str(d / "metrics.prom"),
                         alerts_out=str(d / "incidents.jsonl"),
                         metrics_every_s=300.0)


def dir_bytes(d) -> dict:
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))
            if (d / f).is_file()}


class _Crash(Exception):
    pass


def crash_run(sc, rundir, at_tick, *, obs=None, backend="jsonl",
              snapshot_every_s=600.0, resume=False):
    """Drive a durable run (fresh, or resumed from its newest snapshot) and
    abandon it after `at_tick` completed ticks, leaving the directory as a
    killed process would: no report, no final manifest."""
    run = (DurableRun.open(rundir) if resume else
           DurableRun.create(sc, rundir, obs=obs, backend=backend,
                             snapshot_every_s=snapshot_every_s))
    snap_cb = run._tick_callback()

    def cb(ticks_done, t):
        snap_cb(ticks_done, t)
        if ticks_done >= at_tick:
            raise _Crash

    if resume:    # the surviving obs prefixes, read before the files reopen
        _path, snap = run._pick_snapshot()
        prefixes = run._read_obs_prefixes(snap)
    run.cp = ControlPlane(run.scenario, predictor=PRED, obs=run.obs,
                          device="cpu")
    start = {}
    if resume:
        restore_control(run.cp, snap, store=run.store, obs_prefixes=prefixes)
        run.store.truncate(snap["bus"]["n_events"])
        start = dict(start_tick=snap["tick_i"], start_t=snap["t"])
    else:
        run.store.truncate(0)
    run.cp.bus.attach_sink(run.store.append)
    with pytest.raises(_Crash):
        run.cp.run(tick_callback=cb, **start)
    run.store.close()
    del run
    gc.collect()


# ------------------------------------------------------------------ the store
def events(pkg_events, n):
    ev_cls, kinds = pkg_events.Event, list(pkg_events.EventKind)
    return [ev_cls(seq=i, t=30.0 * i, kind=kinds[i % len(kinds)],
                   device=i % 7 - 1, job=i % 5 - 1,
                   data=(("k", i), ("f", 0.1 * i), ("x", 1.0 / (i + 3))))
            for i in range(n)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_store_round_trip_chain_and_truncate(backend, tmp_path):
    from repro_torch.cluster import events as t_ev
    store = open_store(str(tmp_path / "ev"), backend, segment_events=5)
    evs = events(t_ev, 23)
    for ev in evs:
        store.append(ev)
    store.flush()
    assert store.count() == 23 and list(store.read(0, 23)) == evs
    chain = store.chain()
    assert len(chain) == 4 and len({r["chain"] for r in chain}) == 4
    assert store.verify() == []
    store.truncate(7)           # inside the second sealed segment
    assert list(store.read(0, 7)) == evs[:7]
    for ev in evs[7:]:
        store.append(ev)
    store.flush()
    assert store.chain() == chain and store.verify() == []
    with pytest.raises(ValueError):
        store.append(Event(99, 0.0, EventKind.SCHEDULE))
    store.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_store_bytes_and_chain_equal_repro(backend, tmp_path):
    """One event stream through both packages' stores: the same segment
    bytes and index.json (jsonl), the same chain and replay digest (both)."""
    from repro.cluster import events as j_ev
    from repro.durability import open_store as j_open
    from repro_torch.cluster import events as t_ev
    out = {}
    for tag, opener, ev_mod in (("t", open_store, t_ev),
                                ("j", j_open, j_ev)):
        store = opener(str(tmp_path / tag), backend, segment_events=6)
        for ev in events(ev_mod, 20):
            store.append(ev)
        store.flush()
        out[tag] = (store.chain(), store.replay_digest(20).hexdigest())
        store.close()
    assert out["t"] == out["j"]
    if backend == "jsonl":
        assert dir_bytes(tmp_path / "t") == dir_bytes(tmp_path / "j")


def test_store_torn_tail_and_retry_ladder(tmp_path):
    from repro_torch.chaos import ScriptedInjector
    from repro_torch.cluster import events as t_ev
    root = str(tmp_path / "ev")
    evs = events(t_ev, 6)
    store = JsonlEventStore(root, segment_events=100)
    inj = ScriptedInjector(store_faults=2)
    store.fault_injector = inj
    for ev in evs:
        store.append(ev)
    assert store.io_faults == 2 and store.io_retries == 2
    assert sum(a for _, a in inj.recovered) == 2
    store.close()
    with open(os.path.join(root, "segment-000000000.jsonl"), "a") as f:
        f.write('{"seq": 6, "t": 180.0, "kin')      # torn mid-write
    store = JsonlEventStore(root, segment_events=100)
    assert store.count() == 6 and list(store.read(0, 6)) == evs
    store.close()


# ----------------------------------------------- durable runs against repro
def test_durable_run_equals_repro(tmp_path):
    """fault-storm with every obs output: report, obs files, WAL segments
    and index.json are repro's bytes."""
    import repro.obs as j_obs
    from repro.cluster.scenario import scenario_by_name as j_scenario
    from repro.durability import run_durable as j_run_durable
    got = run_durable(storm(), str(tmp_path / "t" / "run"),
                      obs=obs_for(t_obs, tmp_path / "t"),
                      snapshot_every_s=600.0, predictor=PRED, device="cpu")
    got.finalize_manifest()
    want = j_run_durable(
        j_scenario("fault-storm").with_overrides(n_devices=32, hours=1.0,
                                                 tick_s=60.0, seed=0),
        str(tmp_path / "j" / "run"), obs=obs_for(j_obs, tmp_path / "j"),
        snapshot_every_s=600.0, predictor=PRED)
    want.finalize_manifest()
    assert canon(got.report) == canon(want.report)
    assert got.report["events"]["n_events"] > 20
    t, j = dir_bytes(tmp_path / "t"), dir_bytes(tmp_path / "j")
    assert sorted(t) == sorted(OBS_FILES) and t == j
    assert (dir_bytes(tmp_path / "t" / "run" / "events")
            == dir_bytes(tmp_path / "j" / "run" / "events"))
    meta = {}
    for tag in ("t", "j"):
        text = (tmp_path / tag / "run" / "run.json").read_text()
        meta[tag] = text.replace(str(tmp_path / tag), "D")
    assert meta["t"] == meta["j"]   # the device is recorded nowhere
    assert got.snapshots_taken == want.snapshots_taken == 5
    assert verify_manifest(str(tmp_path / "t" / "run" / "manifest.json")) \
        == []


# ------------------------------------------------------- crash and resume
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_crash_resume_byte_identical(backend, engine, tmp_path):
    """Killed at tick 45 (snapshots at 10..40, the oldest already pruned),
    resumed from tick 40: the report, the four obs files and the WAL are
    the uninterrupted run's."""
    sc = storm(engine)
    base = run_durable(sc, str(tmp_path / "base" / "run"),
                       obs=obs_for(t_obs, tmp_path / "base"),
                       snapshot_every_s=600.0, backend=backend,
                       predictor=PRED, device="cpu")
    base.finalize_manifest()
    crash_run(sc, str(tmp_path / "crash" / "run"), 45,
              obs=obs_for(t_obs, tmp_path / "crash"), backend=backend)
    snaps = sorted(os.listdir(tmp_path / "crash" / "run" / "snapshots"))
    assert snaps == ["snap-0000020.pkl", "snap-0000030.pkl",
                     "snap-0000040.pkl"]
    resumed = resume_run(str(tmp_path / "crash" / "run"), predictor=PRED,
                         device="cpu")
    resumed.finalize_manifest()
    assert resumed.resumed_from_tick == 40
    assert canon(resumed.report) == canon(base.report)
    assert dir_bytes(tmp_path / "crash") == dir_bytes(tmp_path / "base")
    assert diff_runs(str(tmp_path / "base" / "run"),
                     str(tmp_path / "crash" / "run"))["identical"]


def test_crash_before_first_snapshot_restarts(tmp_path):
    sc = storm("torch")
    base = run_durable(sc, str(tmp_path / "base"), predictor=PRED,
                       device="cpu")
    crash_run(sc, str(tmp_path / "crash"), 5, snapshot_every_s=1800.0)
    resumed = resume_run(str(tmp_path / "crash"), predictor=PRED,
                         device="cpu")
    assert resumed.resumed_from_tick is None
    assert canon(resumed.report) == canon(base.report)


def test_double_crash_resume(tmp_path):
    """A resume that itself dies is resumable again from a later
    snapshot."""
    sc = storm("torch")
    base = run_durable(sc, str(tmp_path / "base" / "run"),
                       obs=obs_for(t_obs, tmp_path / "base"),
                       snapshot_every_s=600.0, predictor=PRED, device="cpu")
    base.finalize_manifest()
    rundir = str(tmp_path / "crash" / "run")
    crash_run(sc, rundir, 15, obs=obs_for(t_obs, tmp_path / "crash"))
    crash_run(sc, rundir, 38, resume=True)
    resumed = resume_run(rundir, predictor=PRED, device="cpu")
    resumed.finalize_manifest()
    assert resumed.resumed_from_tick == 30
    assert canon(resumed.report) == canon(base.report)
    assert dir_bytes(tmp_path / "crash") == dir_bytes(tmp_path / "base")


# ------------------------------------------------------------- the manifest
def test_manifest_signature_equals_repro_and_detects_tampering(tmp_path):
    from repro.durability import manifest as j_man
    from repro_torch.durability import manifest as t_man
    assert (t_man.KEY_ENV, t_man.DEV_KEY) == (j_man.KEY_ENV, j_man.DEV_KEY)
    (tmp_path / "a.json").write_text('{"x": 1}\n')
    body = t_man.build_manifest(str(tmp_path), [str(tmp_path / "a.json")],
                                {"scenario": "smoke", "seed": 0})
    assert body == j_man.build_manifest(
        str(tmp_path), [str(tmp_path / "a.json")],
        {"scenario": "smoke", "seed": 0})
    unsigned = {k: v for k, v in body.items() if k != "signature"}
    assert sign_manifest(unsigned) == j_man.sign_manifest(unsigned)
    path = str(tmp_path / "manifest.json")
    j_man.write_manifest(path, body)
    assert verify_manifest(path) == []          # repro signed, port verifies
    (tmp_path / "a.json").write_text('{"x": 2}\n')
    assert any("a.json" in p for p in verify_manifest(path))
    doc = json.loads(open(path).read())
    doc["run"]["scenario"] = "evil"
    with open(path, "w") as f:
        json.dump(doc, f)
    assert any("signature" in p for p in verify_manifest(path))


# -------------------------------------------------------------- forensics
@pytest.fixture(scope="module")
def storm_dirs(tmp_path_factory):
    """Durable fault-storm runs written by each package: seed 0 twice and
    seed 1, with alerting, small segments and every snapshot kept."""
    import repro.obs as j_obs
    from repro.cluster.scenario import scenario_by_name as j_scenario
    from repro.durability import DurableRun as JDurableRun
    tmp = tmp_path_factory.mktemp("forensics")
    dirs = {}
    for tag, run_cls, obs_pkg, sc_of, kw in (
            ("t", DurableRun, t_obs, scenario_by_name, {"device": "cpu"}),
            ("j", JDurableRun, j_obs, j_scenario, {})):
        for name, seed in (("a", 0), ("a2", 0), ("b", 1)):
            d = tmp / tag / name
            d.mkdir(parents=True)
            sc = sc_of("fault-storm").with_overrides(
                n_devices=32, hours=1.0, tick_s=60.0, seed=seed)
            obs = obs_pkg.ObsConfig(alerts_out=str(d / "incidents.jsonl"),
                                    metrics_every_s=300.0)
            run = run_cls.create(sc, str(d / "run"), obs=obs,
                                 snapshot_every_s=600.0, keep_snapshots=99,
                                 segment_events=40)
            run.execute(predictor=PRED, **kw)
            run.finalize_manifest()
            dirs[tag, name] = str(d / "run")
    return dirs


def test_inspect_equals_repro(storm_dirs):
    from repro.durability import dump_inspection as j_dump
    from repro.durability import inspect_run as j_inspect
    want = j_dump(j_inspect(storm_dirs["j", "a"], 25, predictor=PRED))
    got = dump_inspection(inspect_run(storm_dirs["t", "a"], 25,
                                      predictor=PRED, device="cpu"))
    assert got == want
    assert json.loads(got)["tick"] == 25
    full = dump_inspection(inspect_run(storm_dirs["t", "a"], 25,
                                       from_start=True, predictor=PRED,
                                       device="cpu"))
    assert full == got


@pytest.mark.parametrize("pair", [("a", "a2"), ("a", "b")])
def test_diff_equals_repro(pair, storm_dirs):
    """Identical seeds diff clean; seeds 0 and 1 diverge at the same first
    sequence number in both packages, with the same document."""
    from repro.durability import diff_runs as j_diff
    from repro_torch.obs.export import canonical_json
    got = diff_runs(storm_dirs["t", pair[0]], storm_dirs["t", pair[1]])
    want = j_diff(storm_dirs["j", pair[0]], storm_dirs["j", pair[1]])
    assert canonical_json(got) == canonical_json(want)
    assert got["identical"] is (pair[1] == "a2")
    if not got["identical"]:
        assert got["first_divergence"]["seq"] >= 0


# ------------------------------------------------------------------- chaos
def test_chaos_verification_equals_repro(tmp_path):
    from repro.chaos.harness import run_chaos_verification as j_verify
    from repro_torch.chaos.harness import (VERIFY_SCHEMA,
                                           run_chaos_verification)
    kw = dict(devices=24, hours=2.0, seed=7, snapshot_every_s=900.0,
              predictor=PRED)
    got = run_chaos_verification("chaos-storm", workdir=str(tmp_path / "t"),
                                 engine="torch", device="cpu", **kw)
    want = j_verify("chaos-storm", workdir=str(tmp_path / "j"), **kw)
    assert got["schema"] == VERIFY_SCHEMA
    assert got["ok"], got["invariants"]
    names = {i["name"] for i in got["invariants"]}
    assert {"faults-injected", "fault-recovery-pairing", "zero-event-loss",
            "store-retry-ladder", "slo-degradation-budget",
            "recovery-byte-identity", "snapshot-skip-to-next-good"} <= names
    assert got["engine"] == "torch" and want["engine"] == "numpy"
    assert canon(dict(got, engine=None)) == canon(dict(want, engine=None))


# --------------------------------------------------------------- front door
FRONT = ["--devices", "24", "--hours", "1", "--metrics-every", "300"]


def obs_flags(d) -> list:
    return ["--metrics-out", str(d / "metrics.jsonl"),
            "--trace-out", str(d / "trace.jsonl"),
            "--prom-out", str(d / "metrics.prom"),
            "--alerts-out", str(d / "incidents.jsonl"),
            "--durable", str(d / "run"), "--snapshot-every", "900"]


@pytest.mark.parametrize("name", ["mig-partition", "tally-slice"])
def test_cli_durable_obs_equals_repro(name, tmp_path, capsys):
    """Every obs flag and --durable: stdout, the four obs files and the WAL
    cmp equal to `python -m repro sim`'s; run.json differs only in the
    engine (the port's default is torch) and the paths."""
    from repro import cli as j_cli
    out = {}
    for tag, main, extra in (("j", j_cli.main, []),
                             ("t", cli.main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        assert main(["sim", *extra, "--scenario", name, *FRONT,
                     *obs_flags(d)]) == 0
        out[tag] = capsys.readouterr()
    assert out["t"].out == out["j"].out
    assert "[durable]" in out["t"].err and "[obs] metrics" in out["t"].err
    t, j = tmp_path / "t", tmp_path / "j"
    assert dir_bytes(t) == dir_bytes(j)
    assert dir_bytes(t / "run" / "events") == dir_bytes(j / "run" / "events")
    meta_t = json.loads((t / "run" / "run.json").read_text()
                        .replace(str(t), "D"))
    meta_j = json.loads((j / "run" / "run.json").read_text()
                        .replace(str(j), "D"))
    assert meta_t.pop("engine") == "torch" and meta_j.pop("engine") == "numpy"
    assert meta_t == meta_j


def test_cli_resume_verify_inspect_diff_chaos_on_cpu(tmp_path, capsys):
    from repro import cli as j_cli
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        d.mkdir()
        assert cli.main(["sim", "--device", "cpu", "--scenario",
                         "mig-partition", *FRONT, *obs_flags(d)]) == 0
    first = capsys.readouterr().out
    assert cli.main(["sim", "--device", "cpu", "--resume",
                     str(a / "run")]) == 0
    got = capsys.readouterr()
    assert first.startswith(got.out) and "resumed" in got.err
    assert cli.main(["sim", "--verify-manifest",
                     str(a / "run" / "manifest.json")]) == 0
    assert "manifest OK" in capsys.readouterr().err
    assert cli.main(["inspect", str(a / "run"), "--tick", "20",
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["tick"] == 20
    assert cli.main(["diff", str(a / "run"), str(b / "run")]) == 0
    assert json.loads(capsys.readouterr().out)["identical"] is True
    assert cli.main(["serve", "--list-alert-rules"]) == 0
    rules = capsys.readouterr().out
    assert j_cli.main(["serve", "--list-alert-rules"]) == 0
    assert rules == capsys.readouterr().out
    assert cli.main(["chaos", "--device", "cpu", "--scenario", "smoke",
                     "--workdir", str(tmp_path / "w")]) == 2
    assert "no chaos config" in capsys.readouterr().err
    assert cli.main(["chaos", "--device", "cpu", "--devices", "24",
                     "--hours", "2", "--seed", "7",
                     "--workdir", str(tmp_path / "w"),
                     "--no-crash"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True


def test_cli_commands_refuse_to_run_without_a_card(tmp_path, capsys,
                                                    monkeypatch):
    rundir = tmp_path / "run"
    assert cli.main(["sim", "--device", "cpu", "--scenario",
                     "mig-partition", *FRONT, "--durable", str(rundir)]) == 0
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["sim", "--resume", str(rundir)],
                 ["serve", "--resume", str(rundir)],
                 ["inspect", str(rundir), "--tick", "5"],
                 ["chaos", "--workdir", str(tmp_path / "w")]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    # reading files needs no device
    assert cli.main(["diff", str(rundir), str(rundir)]) == 0
    assert cli.main(["sim", "--verify-manifest",
                     str(rundir / "manifest.json")]) == 0


def test_api_surface_equals_repro():
    import repro.api as j_api
    import repro_torch.api as t_api
    assert t_api.__all__ == j_api.__all__
    for name in t_api.__all__:
        mod = getattr(getattr(t_api, name), "__module__", None)
        assert mod is None or mod.split(".")[0] == "repro_torch", name


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_durable_smoke_on_the_card_resumes_byte_equal(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sc = scenario_by_name("smoke").with_overrides(engine="torch")
    base = run_durable(sc, str(tmp_path / "base" / "run"),
                       obs=obs_for(t_obs, tmp_path / "base"),
                       snapshot_every_s=600.0, predictor=PRED,
                       device="cuda")
    base.finalize_manifest()
    rundir = str(tmp_path / "crash" / "run")
    run = DurableRun.create(sc, rundir, obs=obs_for(t_obs, tmp_path / "crash"),
                            snapshot_every_s=600.0)
    snap_cb = run._tick_callback()

    def cb(ticks_done, t):
        snap_cb(ticks_done, t)
        if ticks_done >= 45:
            raise _Crash

    run.cp = ControlPlane(sc, predictor=PRED, obs=run.obs, device="cuda")
    run.cp.bus.attach_sink(run.store.append)
    with pytest.raises(_Crash):
        run.cp.run(tick_callback=cb)
    run.store.close()
    del run
    gc.collect()
    resumed = resume_run(rundir, predictor=PRED, device="cuda")
    resumed.finalize_manifest()
    assert resumed.resumed_from_tick is not None
    assert canon(resumed.report) == canon(base.report)
    assert dir_bytes(tmp_path / "crash") == dir_bytes(tmp_path / "base")
