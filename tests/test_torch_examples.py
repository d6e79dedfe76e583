"""The four example ports (`examples/torch_*.py`) on the CPU, each against
`repro`'s example or the `repro.api` calls it makes: quickstart's lines and
plan under one numpy predictor, cluster_sim's rows and campaign at a
reduced size (exact equality: host code over the same inputs), train_lm's
evict-and-resume at 20 steps (the lines, resume step and steps per phase
of `repro`'s example), and serve_multiplex's graceful exit under a
real SIGINT in a child process at SMOKE."""
import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _numpy_predictor import NumpyPredictor

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shared(monkeypatch, *examples, gpu_types=("T4", "A10", "A100")):
    """One numpy predictor in place of every one the examples (and, for
    the port, its control plane) would train."""
    import repro_torch.core.predictor
    pred = NumpyPredictor(gpu_types=gpu_types)
    for mod in (*examples, repro_torch.core.predictor):
        monkeypatch.setattr(mod, "build_speed_predictor", lambda **kw: pred)
    return pred


def test_quickstart_equals_repro(capsys, monkeypatch):
    import repro.api as japi
    original, port = _load("quickstart"), _load("torch_quickstart")
    pred = _shared(monkeypatch, original, port, gpu_types=("T4",))
    original.main()
    want = capsys.readouterr().out
    out = port.main(device="cpu")
    got = capsys.readouterr().out
    assert got == want
    assert "\n".join(out["devices"]) in got
    # the plan, unrounded, against repro.api.schedule on the same inputs
    rng = np.random.default_rng(0)
    services = ["recommend", "translate", "vision"]
    slots = [japi.OnlineSlot(i, "T4", japi.online_profile(
        services[i % 3], float(rng.uniform(15, 180)))) for i in range(6)]
    jobs = [japi.OfflineJob(j, japi.OFFLINE_MODEL_PROFILES[m], 3600.0)
            for j, m in enumerate(
                rng.choice(list(japi.OFFLINE_MODEL_PROFILES), 4))]
    plan = japi.schedule(slots, jobs, pred)
    assert out["plan"] == [(a.device_id, a.job_id, a.sm_share,
                            a.predicted_tput) for a in plan]
    assert len(plan) == 4


# cluster_sim at a reduced size: the policies that need no predictor, and
# muxflow; the campaign's policy (muxflow) schedules with the same predictor
SIZE = dict(n_devices=24, hours=1.0)
POLICIES = ("online-only", "pb-time-sharing", "time-sharing",
            "tally-priority", "static-partition", "muxflow")


def test_cluster_sim_equals_repro_api(capsys, monkeypatch):
    import repro.api as japi
    port = _load("torch_cluster_sim")
    pred = _shared(monkeypatch, port)
    out = port.main(**SIZE, policies=POLICIES, campaign_hours=0.5,
                    device="cpu")
    printed = capsys.readouterr().out
    assert "simulating 1h on 24 GPUs, trace C..." in printed
    cfg = dict(n_devices=24, horizon_s=3600.0, tick_s=60.0, trace="C",
               seed=0)
    for pol in POLICIES:
        use = pred if japi.resolve(pol).needs_predictor else None
        want = japi.run_policy_scenario(pol, use, **cfg)
        assert dataclasses.asdict(out["rows"][pol]) == \
            dataclasses.asdict(want), pol
        assert printed.count(f"\n{pol:18s} ") == 1
    want = japi.run_scenario("diurnal-mixed", predictor=pred, n_devices=24,
                             hours=0.5, seed=0)
    assert json.dumps(out["campaign"], sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    assert out["rows"]["muxflow"].oversold_gpu > 0.0


def _masked(text: str) -> list:
    """The printed lines with the framework-dependent numbers masked: the
    losses and the step times."""
    return [re.sub(r"\(\d+ ms/step\)", "(# ms/step)",
                   re.sub(r"\d+\.\d+", "#", ln))
            for ln in text.splitlines()]


def test_train_lm_resumes_from_its_checkpoint(capsys, monkeypatch):
    original = _load("train_lm")
    runs, resumed = [], []
    run, latest_step = original.run, original.latest_step

    def recorded_run(*args, **kwargs):
        runs.append(run(*args, **kwargs))
        return runs[-1]

    def recorded_latest_step(path):
        resumed.append(latest_step(path))
        return resumed[-1]

    monkeypatch.setattr(original, "run", recorded_run)
    monkeypatch.setattr(original, "latest_step", recorded_latest_step)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "20"])
    original.main()
    want = capsys.readouterr().out
    out = _load("torch_train_lm").main(["--steps", "20", "--device", "cpu"])
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    assert "[train] resumed from step 10" in got
    assert [out["resumed_from"]] == resumed == [10]
    assert out["phase1"]["steps_done"] == runs[0]["steps_done"] == 10
    assert out["phase2"]["steps_done"] == runs[1]["steps_done"] == 10
    assert out["phase2"]["final_loss"] < out["phase1"]["losses"][0]


SERVE = ("import json, sys\n"
         "sys.path.insert(0, {examples!r})\n"
         "import torch_serve_multiplex as example\n"
         "out = example.main(smoke=True, n_req={n_req}, device='cpu')\n"
         "print(json.dumps(out))\n")


def test_serve_multiplex_catches_a_real_sigint():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SERVE.format(examples=str(EXAMPLES),
                                            n_req=24)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    out = json.loads(lines[-1])
    assert out["triggered"] == "sigint", out
    assert out["frozen"] is True
    assert out["checkpoint_step"] is not None and out["releases"] == 1
    assert out["offline_steps_after_signal"] == 0
    assert out["online_steps_after_signal"] >= 1 or out["evicted"], out
    assert out["offline_steps"] >= 1 and out["served"] >= 1
    # the original's printed lines, in its order
    assert lines[0].startswith("online decode step (batch 8): ")
    assert lines[1].startswith("offline train microstep: ")
    assert any(ln.startswith("graceful exit: caught sigint -> froze kernel "
                             "launches (frozen=True), checkpointed at step")
               for ln in lines)
    assert "online kept serving after the signal: errors propagated = 0" \
        in lines


def test_examples_refuse_the_cpu_without_asking():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    refused = [
        lambda: _load("torch_quickstart").main(),
        lambda: _load("torch_cluster_sim").main(n_devices=4, hours=0.1),
        lambda: _load("torch_train_lm").main(["--steps", "2"]),
        lambda: _load("torch_serve_multiplex").main(n_req=2),
    ]
    for fn in refused:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
