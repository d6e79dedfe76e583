"""`repro`'s small leftovers in the port, each against its `repro`
counterpart: `GPUMonitor`'s rolling buffer, `ElasticCoordinator`'s plans,
the deprecated entry points (`cluster/run.py`, `profiling/run.py`) and
`cli.deprecation_note`.  Host code on both sides: results equal exactly."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch import cli
from repro_torch.core.protection import GPUMonitor, VirtualClock
from repro_torch.runtime import (ElasticCoordinator, ElasticPlan,
                                 HeartbeatMonitor)


def _monitor_trace(protection):
    """test_protection.py's case, then more samples past the horizon, with
    the buffer's state after each: samples, latest, means."""
    clock = protection.VirtualClock(start=100.0)
    mon = protection.GPUMonitor(horizon_s=10.0, clock=clock)
    out = []
    for dt, util, act, clk, mem in [(0.0, 0.5, 0.3, 1500.0, 0.4),
                                    (15.0, 0.6, 0.4, 1400.0, 0.5),
                                    (3.0, 0.9, 0.8, 1200.0, 0.7),
                                    (4.0, 0.2, 0.1, 1590.0, 0.2),
                                    (4.0, 0.7, 0.6, 1300.0, 0.6),
                                    (10.0, 0.4, 0.2, 1450.0, 0.3)]:
        clock.advance(dt)
        s = mon.sample(gpu_util=util, sm_activity=act, sm_clock=clk,
                       mem_used_frac=mem, power_w=60.0 + 100 * util)
        out.append((dataclasses.astuple(s),
                    [dataclasses.astuple(x) for x in mon.samples],
                    dataclasses.astuple(mon.latest()),
                    [mon.mean(a, w) for a in ("gpu_util", "sm_activity",
                                              "sm_clock", "power_w")
                     for w in (1.0, 5.0, 30.0)]))
    return out


def test_gpu_monitor_equals_repro():
    from repro.core import protection as j_protection
    from repro_torch.core import protection as t_protection
    got = _monitor_trace(t_protection)
    assert got == _monitor_trace(j_protection)
    assert got[1][1] == [got[1][0]]               # the first was pruned
    empty = GPUMonitor(clock=VirtualClock())
    assert empty.latest() is None and empty.mean("gpu_util") == 0.0


def _plans(runtime):
    """test_infra.py's case (node 2 dies), then node 2 rejoins and node 0
    dies: every poll's plan."""
    hb = runtime.HeartbeatMonitor(3, timeout_s=10.0, now=0.0)
    step = [42]
    co = runtime.ElasticCoordinator(hb, get_ckpt_step=lambda: step[0])
    out = []
    for n in range(3):
        hb.heartbeat(n, now=1.0)
    out.append(co.poll(now=2.0))
    for n in (0, 1):
        hb.heartbeat(n, now=15.0)
    out.append(co.poll(now=20.0))
    out.append(co.poll(now=21.0))
    step[0] = 60
    hb.join(2, now=22.0)
    out.append(co.poll(now=23.0))
    for n in (1, 2):
        hb.heartbeat(n, now=30.0)
    out.append(co.poll(now=34.0))
    return [None if p is None else dataclasses.astuple(p) for p in out]


def test_elastic_coordinator_equals_repro():
    from repro.runtime import fault_tolerance as j_ft
    from repro_torch import runtime as t_rt
    got = _plans(t_rt)
    assert got == _plans(j_ft)
    assert got == [None, ([0, 1], 42, "node_failure"), None,
                   ([0, 1, 2], 60, "node_join"),
                   ([1, 2], 60, "node_failure")]
    co = ElasticCoordinator(HeartbeatMonitor(1, now=0.0), lambda: 0)
    assert co.poll(now=1.0) is None
    assert ElasticPlan([0], 0, "node_join").world == [0]


def test_deprecation_note_equals_repro(capsys):
    from repro import cli as j_cli
    j_cli.deprecation_note("python -m repro.cluster.run", "python -m repro sim")
    want = capsys.readouterr()
    cli.deprecation_note("python -m repro_torch.cluster.run",
                         "python -m repro_torch sim")
    got = capsys.readouterr()
    assert got.out == want.out == ""
    assert got.err == want.err.replace("repro", "repro_torch")


SIM = ["--scenario", "mig-partition", "--devices", "24", "--hours", "1"]


def test_cluster_run_shim_equals_the_cli_and_repro(capsys):
    from repro.cluster import run as j_run
    from repro_torch.cluster import run as t_run
    assert j_run.main(SIM) == 0
    want = capsys.readouterr()
    assert t_run.main(["--device", "cpu", *SIM]) == 0
    got = capsys.readouterr()
    assert cli.main(["sim", "--device", "cpu", *SIM]) == 0
    direct = capsys.readouterr()
    assert got.out == direct.out == want.out
    note = got.err.splitlines()[0]
    assert note == want.err.splitlines()[0].replace("repro", "repro_torch")
    assert note.startswith("note: `python -m repro_torch.cluster.run` is "
                           "deprecated; use `python -m repro_torch sim`")
    assert "deprecated" not in direct.err


def test_cluster_run_reexports_the_schema():
    from repro_torch.cluster import control, run
    assert run.check_schema is control.check_schema
    assert run.SCHEMA_KEYS is control.SCHEMA_KEYS
    assert run.REPORT_SCHEMA == control.REPORT_SCHEMA
    assert run.check_schema({}) != []


def test_profiling_run_shim_equals_the_cli(capsys):
    from repro.profiling import run as j_run
    from repro_torch.profiling import run as t_run
    assert j_run.main(["--list"]) == 0
    want = capsys.readouterr()
    flags = ["--suite", "smoke", "--seed", "0", "--device", "cpu"]
    assert t_run.main(flags) == 0
    got = capsys.readouterr()
    assert cli.main(["profile", *flags]) == 0
    direct = capsys.readouterr()
    assert got.out == direct.out and got.out.startswith("{")
    assert got.err.splitlines()[0] == \
        want.err.splitlines()[0].replace("repro", "repro_torch")
    assert "deprecated" not in direct.err


def test_cluster_run_shim_runs_as_a_module():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    sim = subprocess.run(
        [sys.executable, "-m", "repro_torch.cluster.run", "--device", "cpu",
         "--scenario", "mig-partition", "--devices", "8", "--hours", "0.5"],
        env=env, cwd=root, capture_output=True, text=True, timeout=300)
    assert sim.returncode == 0, sim.stderr
    assert json.loads(sim.stdout)["scenario"]["n_devices"] == 8
    assert sim.stderr.startswith("note: `python -m repro_torch.cluster.run`")
