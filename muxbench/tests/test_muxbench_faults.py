"""The harness's run, with the chip's look skipped and the timed path
broken underneath (`muxbench/faults.py`), comes out not correct, once for
each fault a cell can have; unbroken, it comes out correct.  The port runs
in fp32 here, where a sound run reads rounding alone, against the
configurations' own limits."""
import pytest
from conftest import CELLS, smoke_run

from muxbench import faults


def test_unbroken_run_is_correct():
    assert smoke_run("danube-1.8b.share-poisson")["correct"]


AFTER = 3      # the mixes' checked_steps: the set-up steps


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    with faults.planted(fault, AFTER):
        out = smoke_run(cell)
    assert not out["correct"], (fault, out["checks"])
    over = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert over, out["checks"]
    if fault.startswith("late_"):
        # the set-up steps were sound: the checked window step caught it
        assert all(k.startswith("window_") for k in over), over


@pytest.mark.parametrize("at", [0.0, 2.0])
def test_a_window_step_is_checked(at):
    """The first window step that starts after the drawn time is checked;
    where none starts after it, one more step after the close is."""
    import time

    from conftest import SEED, smoke_parts

    import torch

    from muxbench import bench
    torch.set_num_threads(1)
    parts = smoke_parts(CELLS[0])
    parts["mix"]["offline"]["check_window"] = [at, at]
    out = bench.run(parts, seed=SEED, seconds=1.0, trace=False,
                    t_process=time.perf_counter(), device="cpu")
    assert out["correct"], out["checks"]
    rd = out["_readings"]
    offline = [s for s in out["_record"].spans if s.kind == "offline"]
    assert rd["window_step_after_close"] == (at > 1.0)
    assert rd["window_step"] == (offline[0].step if at < 1.0
                                 else offline[-1].step + 1)
