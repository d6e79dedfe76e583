"""The port's `repro_torch.profiling` package exports what
`repro.profiling` exports: the same `__all__`, every name importable
whichever of `repro_torch.policies` and `repro_torch.profiling` is imported
first, the one registered ``muxflow-measured`` policy as
``MEASURED_MUXFLOW``, and the seed-era profiler API (`ProfileStore`,
`profile_step_fn`, `profile_from_trace`) equal to `repro`'s."""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import repro.profiling as jax_profiling
import repro_torch.profiling as profiling
from repro.profiling import workloads as jax_workloads
from repro_torch.core.interference import OFFLINE_MODEL_PROFILES
from repro_torch.profiling import workloads

ROOT = Path(__file__).resolve().parents[1]


def test_all_equals_repros():
    assert profiling.__all__ == jax_profiling.__all__
    assert len(profiling.__all__) == 23
    for name in profiling.__all__:
        assert hasattr(profiling, name), name


@pytest.mark.parametrize("first", ["repro_torch.policies",
                                   "repro_torch.profiling"])
def test_every_name_imports_in_either_order(first):
    """A fresh interpreter, jax and repro blocked: import `first`, then the
    other package, then every exported name; the measured policy is
    registered once and is the object both packages bind."""
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[n] = None\n"
        f"import {first}\n"
        "import repro_torch.policies as pol\n"
        "import repro_torch.profiling as prof\n"
        "from repro_torch.profiling import *  # noqa: F401,F403\n"
        "for name in prof.__all__:\n"
        "    getattr(prof, name)\n"
        "assert prof.MEASURED_MUXFLOW is pol.MEASURED_MUXFLOW\n"
        "assert pol.resolve('muxflow-measured') is prof.MEASURED_MUXFLOW\n"
        "assert pol.available().count('muxflow-measured') == 1\n"
        "print(len(prof.__all__))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "23"


def test_profile_store_matches_repros():
    store, jstore = profiling.ProfileStore(), jax_profiling.ProfileStore()
    assert [f.name for f in dataclasses.fields(store)] == [
        f.name for f in dataclasses.fields(jstore)]
    name = sorted(OFFLINE_MODEL_PROFILES)[0]
    for s in (store, jstore):
        assert s.get(name) is None
        s.put(name, OFFLINE_MODEL_PROFILES[name])
        assert s.get(name) is OFFLINE_MODEL_PROFILES[name]
    assert store.profiles.keys() == jstore.profiles.keys()


@pytest.mark.parametrize("model", sorted(OFFLINE_MODEL_PROFILES))
def test_profile_from_trace_matches_repros(model):
    got = profiling.profile_from_trace(model)
    want = jax_profiling.profile_from_trace(model)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


class Clock:
    """A time.perf_counter that advances by `tick` seconds a call: the
    timed loop of `iters` steps reads it twice, so a step takes
    tick / iters."""

    def __init__(self, tick: float):
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


@pytest.mark.parametrize("tick,flops,nbytes", [
    (0.004, 1e9, 2e8), (1e-6, 4e13, 1e13), (2.0, 0.0, 0.0)])
def test_profile_step_fn_matches_repros(monkeypatch, tick, flops, nbytes):
    """Both on one clock, the peaks given: the same profile, field for
    field; the step runs warmup + iters times."""
    kw = dict(name="step", warmup=2, iters=5, flops_per_step=flops,
              bytes_per_step=nbytes, peak_flops=5e13, peak_bw=1e12,
              mem_bytes=3 << 30)
    calls = []
    profiles = []
    for fn in (workloads.profile_step_fn, jax_workloads.profile_step_fn):
        monkeypatch.setattr(time, "perf_counter", Clock(tick))
        profiles.append(fn(lambda: calls.append(1), **kw))
    assert len(calls) == 2 * (2 + 5)
    assert dataclasses.asdict(profiles[0]) == dataclasses.asdict(profiles[1])
    assert profiles[0].exec_time_ms == pytest.approx(tick * 1e3 / 5)


def test_profile_step_fn_defaults_to_the_h100s_peaks(monkeypatch):
    """Without peaks the port divides by one H100's dense bf16 FLOP/s and
    HBM bytes/s, not by the TPU's figures `repro` defaults to."""
    monkeypatch.setattr(time, "perf_counter", Clock(5e-3))    # 1 ms a step
    prof = workloads.profile_step_fn(lambda: None, name="s",
                                     flops_per_step=0.5 * 989e12 * 1e-3,
                                     bytes_per_step=0.25 * 3.35e12 * 1e-3)
    assert prof.sm_activity == pytest.approx(0.5)
    assert prof.mem_bw == pytest.approx(0.25)
