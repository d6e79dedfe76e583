"""Runs one cell of the benchmark once and prints its result line.

  python3 muxbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout (BENCHMARK.json beside `muxbench/` and the
program under `src/`).  The last line of standard output is one JSON
object; the numbers the check compared, each beside its limit, are the
last lines of standard error.  Exits with 3, printing no result, when
there is no CUDA device or fewer than the cell asks for, and with 4 when
the process holds a JAX module once the window has closed.  Python's
bytecode and every build of the program stay inside the checkout
(`build/`).
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def prepare_process() -> None:
    """Before torch is imported: bytecode and every build cache inside the
    checkout, the harness and the program on the path, and one host thread
    for the CPU side of the program (the card's work is launched from the
    main thread; idle pools only add noise)."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from muxbench import bench as B
    parts = B.resolve(bench, args.workload)

    import torch
    need = parts["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = B.run(parts, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), t_process=T_PROCESS)
    bad = B.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the PyTorch port "
              "alone", file=sys.stderr)
        return 4
    out.pop("_record")
    out.pop("_readings")
    lines = out.pop("_lines")
    for ln in lines[:-len(out["checks"]) or None]:
        print(ln, file=sys.stderr)
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    for ln in lines[-len(out["checks"]):]:
        print(ln, file=sys.stderr)
    return 0


if __name__ == "__main__":
    prepare_process()
    sys.exit(main())
