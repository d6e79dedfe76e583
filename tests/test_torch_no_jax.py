"""The port stands alone: no module of `repro_torch`, not chip_smoke.py and
not the example ports (`examples/torch_*.py`) imports `jax` or `repro`;
every module and example imports without them; and the entry points refuse
to run on the CPU unless asked to."""
import ast
import builtins
import os
import shutil
import subprocess
import symtable
import sys
from pathlib import Path

import pytest
import torch

from _numpy_predictor import NumpyPredictor

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10
    assert [f.name for f in EXAMPLES] == [
        "torch_cluster_sim.py", "torch_quickstart.py",
        "torch_serve_multiplex.py", "torch_train_lm.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "new = {'repro_torch.' + m for m in ('cli', '__main__',\n"
        "       'kernels.flash_attention', 'kernels.ssm_scan',\n"
        "       'core.interference', 'core.sysmonitor', 'core.predictor',\n"
        "       'serving_plane.arrivals', 'optim.optimizer', 'data.pipeline',\n"
        "       'models.ssm', 'configs.xlstm_350m', 'profiling.workloads',\n"
        "       'profiling.harness', 'profiling.matrix',\n"
        "       'profiling.calibrate', 'configs.h2o_danube_1_8b',\n"
        "       'checkpoint.checkpointing', 'runtime.fault_tolerance',\n"
        "       'launch.train', 'core.simulator', 'core.engine_torch',\n"
        "       'core.matching', 'core.scheduler', 'core.traces',\n"
        "       'core.dynamic_sm', 'core.errors', 'policies',\n"
        "       'policies.base', 'policies.builtin', 'policies.extra',\n"
        "       'core.autoscaler', 'cluster', 'cluster.events',\n"
        "       'cluster.jobs', 'cluster.fleet', 'cluster.faults',\n"
        "       'cluster.agents', 'cluster.scenario', 'cluster.control',\n"
        "       'serving_plane.admission', 'serving_plane.plane', 'chaos',\n"
        "       'chaos.injector', 'chaos.campaign', 'chaos.harness',\n"
        "       'obs', 'obs.export', 'obs.phases', 'obs.metrics',\n"
        "       'obs.trace', 'obs.alerts', 'obs.plane', 'durability',\n"
        "       'durability.store', 'durability.manifest',\n"
        "       'durability.snapshot', 'durability.runner',\n"
        "       'durability.inspect', 'durability.diff', 'api',\n"
        "       'models.moe', 'configs.pixtral_12b',\n"
        "       'configs.seamless_m4t_medium',\n"
        "       'configs.granite_moe_1b_a400m',\n"
        "       'configs.deepseek_v2_lite_16b',\n"
        "       'configs.jamba_1_5_large_398b', 'serving.kv_quant',\n"
        "       'runtime.compression', 'cluster.run', 'profiling.run',\n"
        "       'core.simulator_legacy')}\n"
        "assert 'repro_torch.launch.serve' in names, names\n"
        "assert new <= set(names), new - set(names)\n"
        "import importlib.util\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code,
                           *map(str, EXAMPLES)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 35


def _read_globals(table, top):
    """Names a scope reads from the module's globals."""
    for sym in table.get_symbols():
        if sym.is_referenced() and (table is top or sym.is_global()):
            yield sym.get_name()
    for child in table.get_children():
        yield from _read_globals(child, top)


def test_no_module_reads_an_unbound_global():
    """Every global name a module of the port (or chip_smoke.py, or an
    example port) reads is bound in that module or is a builtin: a name copied in use but not in
    definition raises NameError only on the path that reads it."""
    known = set(dir(builtins)) | {"__file__", "__name__", "__path__",
                                  "__spec__", "__doc__"}
    bad = {}
    for path in _port_files():
        top = symtable.symtable(path.read_text(), str(path), "exec")
        bound = {s.get_name() for s in top.get_symbols()
                 if s.is_assigned() or s.is_imported() or s.is_namespace()}
        missing = set(_read_globals(top, top)) - bound - known
        if missing:
            bad[str(path.relative_to(ROOT))] = sorted(missing)
    assert not bad, bad


def test_entry_points_refuse_cpu_without_asking(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from repro_torch import resolve_device
    from repro_torch.chaos.harness import run_chaos_verification
    from repro_torch.checkpoint import restore, save
    from repro_torch.cli import main as cli_main
    from repro_torch.cluster.control import run_scenario
    from repro_torch.cluster.scenario import scenario_by_name
    from repro_torch.configs import get_config
    from repro_torch.core.predictor import build_speed_predictor
    from repro_torch.core.simulator import run_policy
    from repro_torch.durability import run_durable
    from repro_torch.launch.serve import run
    from repro_torch.launch.train import run as train_run
    from repro_torch.models import init_cache
    from repro_torch.models.convert import mlp_from_jax, params_from_jax
    from repro_torch.profiling.calibrate import (build_measured_predictor,
                                                 default_matrix)
    from repro_torch.profiling.harness import (SUITES, PairProfiler,
                                               build_speed_matrix)
    from repro_torch.profiling.workloads import build_catalog, execute
    cfg = get_config("mistral-nemo-12b", smoke=True)
    monkeypatch.delenv("REPRO_SPEED_MATRIX", raising=False)
    save(str(tmp_path), 1, [torch.zeros(1)])
    refused = [
        resolve_device,
        lambda: run("mistral-nemo-12b", requests=2),
        lambda: run("h2o-danube-1.8b", share=True, requests=2),
        lambda: run("granite-moe-1b-a400m", requests=2),
        lambda: init_cache(get_config("seamless-m4t-medium", smoke=True), 1,
                           8, src_len=4),
        lambda: init_cache(get_config("deepseek-v2-lite-16b", smoke=True), 1,
                           8),
        lambda: train_run("h2o-danube-1.8b", steps=1),
        lambda: restore(str(tmp_path), [torch.zeros(1)]),
        lambda: init_cache(cfg, 1, 8),
        lambda: params_from_jax({"blocks": [{}]}, cfg),
        lambda: params_from_jax({"blocks": [{}]},
                                get_config("xlstm-350m", smoke=True)),
        lambda: mlp_from_jax([]),
        lambda: execute(build_catalog()["ssm-scan"]),
        lambda: PairProfiler(SUITES["smoke"]),
        lambda: build_speed_matrix("smoke"),
        lambda: build_measured_predictor(None),
        lambda: build_speed_predictor(n=10, epochs=1),
        lambda: run_policy("time-sharing", n_devices=8, horizon_s=600.0,
                           engine="torch"),
        default_matrix,
        lambda: run_scenario("smoke", n_devices=8, hours=0.1),
        lambda: run_scenario("mig-partition", engine="torch", n_devices=8,
                             hours=0.1),
        lambda: run_scenario("calibrated", predictor=NumpyPredictor(),
                             n_devices=8, hours=0.1),
        lambda: cli_main(["sim", "--scenario", "mig-partition",
                          "--engine", "numpy", "--devices", "8"]),
        lambda: cli_main(["serve", "--devices", "8", "--hours", "0.1"]),
        lambda: cli_main(["sim", "--scenario", "mig-partition",
                          "--devices", "8", "--durable",
                          str(tmp_path / "run")]),
        lambda: cli_main(["chaos", "--devices", "8",
                          "--workdir", str(tmp_path / "w")]),
        lambda: run_durable(scenario_by_name("smoke").with_overrides(
            engine="torch", n_devices=8, hours=0.1), str(tmp_path / "d"),
            predictor=NumpyPredictor()),
        lambda: run_chaos_verification("chaos-storm", engine="torch",
                                       workdir=str(tmp_path / "c"),
                                       predictor=NumpyPredictor()),
    ]
    for fn in refused:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    assert resolve_device("cpu") == torch.device("cpu")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "profile",
                           "--out", "unused.json"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "sim",
                           "--scenario", "mig-partition", "--devices", "8"],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert proc.stdout == ""
    assert not (ROOT / "unused.json").exists()


def test_unported_architectures_raise():
    """All ten of `repro`'s architectures are ported: every id resolves, at
    SMOKE and FULL, to a config of its own name; an unknown id still
    raises."""
    from repro_torch.configs import ARCH_IDS, get_config
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        for smoke in (True, False):
            assert get_config(arch, smoke=smoke).name == arch
    with pytest.raises(ValueError, match="unknown"):
        get_config("no-such-arch")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(alone, tmp_path):
    if torch.cuda.is_available() and not alone:
        pytest.skip("this machine has a CUDA card")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
