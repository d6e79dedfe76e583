"""The reference against the port at SMOKE sizes on the CPU: a whole run
of each cell through the harness, the port in fp32 (its plain kernels),
where the two must agree to fp32 rounding; then in bf16, where the
harness's readings must lie under the fp8 control's."""
import pytest
from conftest import CELLS, SEED, smoke_parts, smoke_run


@pytest.mark.parametrize("cell", CELLS)
def test_port_fp32_equals_reference(cell):
    out = smoke_run(cell, "float32")
    got = {k: c["value"] for k, c in out["checks"].items()}
    assert {"served_gap", "grad_leaf_rel", "window_update_leaf_rel"} <= set(got)
    assert max(got.values()) < 1e-4, got
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_port_bf16_is_correct(cell):
    """A bf16 run reads every compared number under the fp8 control's on
    the same inputs.  (The limits are set at the full size, where bf16's
    rounding reads less than at SMOKE's d_model of 64.)"""
    import torch

    from muxbench import control
    out = smoke_run(cell, "bfloat16")
    assert out["failed"] == 0 and out["attempted"] > 0
    ctl = control.readings(smoke_parts(cell, "bfloat16"), SEED,
                           torch.device("cpu"), steps=40, seconds=1.5)
    over = {k: (c["value"], ctl[k]) for k, c in out["checks"].items()
            if c["value"] >= ctl[k]}
    assert not over, over


def test_traced_run_reads_the_layers():
    import time

    import torch

    from muxbench import bench
    torch.set_num_threads(1)
    parts = smoke_parts("danube-1.8b.share-burst")
    # a loose guard: on a busy host the PID would starve the offline side
    # before the traced stretch, and the readers need both sides' steps
    parts["mix"]["mux"]["slo_slowdown"] = 100.0
    out = bench.run(parts, seed=SEED, seconds=1.5, trace=True,
                    t_process=time.perf_counter(), device="cpu")
    assert any(ln.startswith("[trace] offline_share_before_pct=")
               for ln in out["_lines"])
    m = out["metrics"]
    for name in ("online_wait_ms", "offline_share_pct", "decode_step_ms",
                 "decode_step.mfu", "train_step_ms", "train_step.mfu"):
        assert m[name]["value"] > 0, name
    # no device on the CPU: the device readers find nothing to read
    assert "device_idle_pct" not in m and "decode_attention_roofline" not in m
    # the compared numbers come last in the result line
    assert [k for k in out if not k.startswith("_")][-1] == "checks"
