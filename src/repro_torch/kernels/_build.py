"""Builds the CUDA sources under `csrc/` with nvcc, at first use.

Each `csrc/<name>.cu` has a plain C interface and becomes
`build/repro_torch_kernels/lib<name>-<hash>.so` at the repository root,
loaded with `ctypes`; the hash covers the source and the flags, so an edited
source is rebuilt.  nvcc's output, with ptxas's registers, shared memory and
spills of every kernel (`-Xptxas -v`), is kept beside it as `<same>.log`
(`ptxas_report`).  Nothing is compiled at import: the CPU tests import every
module, and a machine without nvcc never reaches this code.  A failed build
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together.  Returns each name's library path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
        else:
            todo[n].with_suffix(".log").write_text(log)
            os.replace(tmp, todo[n])      # atomic: readers never see a part
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)[name]))
        return lib


def build_file(source: Path) -> Path:
    """A library of any CUDA source with the port's flags (for measurement
    tools), in a subdirectory of the build directory keyed by a hash of
    the source and the flags.  Raises with nvcc's output if it fails."""
    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / "tools" / f"{source.stem}-{digest[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


def sources() -> list[str]:
    """Every kernel source under csrc/, by name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def ptxas_report(name: str) -> list[dict]:
    """Registers, spill bytes and shared memory of each kernel in the built
    `csrc/<name>.cu`, as ptxas reported them: one dict per kernel with
    `kernel` (the mangled name), `registers`, `spill_stores`, `spill_loads`
    and `smem` (static bytes).  Empty if the build left no log."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    out, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out
