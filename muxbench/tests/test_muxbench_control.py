"""The control (the reference in fp8, `muxbench/control.py`) comes out not
correct: on the card at each cell's own size, on three seeds, every seed
fails at least one of the cell's limits; on the CPU at SMOKE size it
reads above the bf16 program on most numbers of a configuration."""
import pytest
from conftest import CELLS, ROOT, SEED, bench_json, smoke_parts, smoke_run

from muxbench import bench, control


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in bench_json()["workloads"]])
def test_control_fails_on_the_card(cell, cuda_device):
    b = bench_json()
    parts = bench.resolve(b, cell)
    limits = parts["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        got = control.readings(parts, seed, cuda_device,
                               seconds=b["run_seconds"])
        assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    import torch
    prog = smoke_run(cell, "bfloat16")["checks"]
    ctl = control.readings(smoke_parts(cell, "bfloat16"), SEED,
                           torch.device("cpu"), steps=40, seconds=1.5)
    above = [k for k in prog if ctl[k] > prog[k]["value"]]
    assert len(above) >= 4, (ctl, prog)
    assert (ROOT / "muxbench" / "control.py").exists()
