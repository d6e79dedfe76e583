"""Shared helpers of the benchmark's own tests: the cells at the port's
SMOKE sizes, so that a whole run fits the CPU in seconds."""
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


def smoke_parts(cell: str, dtype: str = "float32") -> dict:
    """The cell's parts with the SMOKE model's sizes (danube's window 32,
    so that the decode's ring wraps) and a small mix."""
    from muxbench import bench
    parts = bench.resolve(bench_json(), cell)
    config = copy.deepcopy(parts["config"])
    m = config["model"]
    m.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=250, vocab_pad_multiple=16,
             window=32)
    config["dtype"] = dtype
    mix = copy.deepcopy(parts["mix"])
    mix["online"].update(prompt_len=24, cache_rows=400)
    mix["offline"].update(batch=2, seq=16, batches=8)
    mix["arrivals"]["rate"] = 20.0
    mix["trace_seconds"] = 0.5
    parts.update(config=config, mix=mix)
    return parts


CELLS = [c["name"] for c in bench_json()["workloads"]]


def smoke_run(cell: str, dtype: str = "float32", trace: bool = False,
              seconds: float = 1.5, seed: int = SEED) -> dict:
    import time

    import torch
    from muxbench import bench
    torch.manual_seed(0)
    # one thread, as a run has: test workers side by side would otherwise
    # oversubscribe the cores and slow each step many times over
    torch.set_num_threads(1)
    return bench.run(smoke_parts(cell, dtype), seed=seed, seconds=seconds,
                     trace=trace, t_process=time.perf_counter(), device="cpu")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, not at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
