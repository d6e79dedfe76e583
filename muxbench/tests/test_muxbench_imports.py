"""No module of the harness imports JAX or the JAX package (top-level
names compared whole: `repro_torch` is not `repro`), and the reference
imports nothing of the program."""
import ast
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_repro():
    files = list((ROOT / "muxbench").rglob("*.py"))
    assert files
    for f in files:
        assert not imported(f) & BANNED, f


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "muxbench" / "reference").rglob("*.py"):
        assert "repro_torch" not in imported(f), f


def test_a_run_loads_no_jax():
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from conftest import smoke_run\n"
        "smoke_run('danube-1.8b.share-poisson', seconds=0.5)\n"
        "from muxbench import bench\n"
        "print(json.dumps(bench.forbidden_modules()))\n"
        % (str(ROOT / "muxbench" / "tests"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
