"""Shared helpers of the benchmark's own tests: the cells at their
configuration's `smoke` sizes, so that a whole run fits the CPU in
seconds."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2 ** 31 + 7


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def smoke_parts(cell: str, dtype: str = "float32", spec: dict | None = None,
                base: Path | None = None) -> dict:
    """The cell's parts with the sizes its configuration file gives under
    `smoke` (danube's window 32, so that the decode's ring wraps) and a
    small mix; `spec` (BENCHMARK.json's) and `base` for a copy of the
    harness."""
    from muxbench import bench
    parts = bench.resolve(spec or bench_json(), cell, base or bench.HERE)
    config = copy.deepcopy(parts["config"])
    config["model"].update(config["smoke"])
    config["dtype"] = dtype
    mix = copy.deepcopy(parts["mix"])
    mix["online"].update(prompt_len=24, cache_rows=400)
    if mix.get("offline"):
        # the mix's own count of batches stays: in a short cycle the
        # stale batch of `late_train_stale_batch` comes round again as the
        # checked step's own, and the fault does not show
        mix["offline"].update(batch=2, seq=16)
    mix["arrivals"]["rate"] = 20.0
    mix["trace_seconds"] = 0.5
    parts.update(config=config, mix=mix)
    return parts


CELLS = [c["name"] for c in bench_json()["workloads"]]


def smoke_run(cell: str, dtype: str = "float32", trace: bool = False,
              seconds: float = 1.5, seed: int = SEED, parts=None) -> dict:
    import time

    import torch
    from muxbench import bench
    torch.manual_seed(0)
    # one thread, as a run has: test workers side by side would otherwise
    # oversubscribe the cores and slow each step many times over
    torch.set_num_threads(1)
    return bench.run(parts or smoke_parts(cell, dtype), seed=seed,
                     seconds=seconds, trace=trace,
                     t_process=time.perf_counter(), device="cpu")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, not at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
