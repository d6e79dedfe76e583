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
    # the counters: the throttle refused some share of the quanta asked,
    # and on the CPU the decode step runs eagerly, never a replay
    assert 0 <= m["offline_quanta_refused_pct"]["value"] <= 100
    assert m["decode_replay_pct"]["value"] == 0.0
    assert any(ln.startswith("[counters] before.granted=")
               for ln in out["_lines"])
    # the program's spans are joined (no device operation on the CPU)
    spans = [ln for ln in out["_lines"] if ln.startswith("[spans] ")]
    assert spans and "ops=0 " in spans[0] and "train.forward:n=" in spans[0]
    # no device on the CPU: the device readers find nothing to read
    for name in ("device_idle_pct", "decode_attention_roofline",
                 "decode_step.device_ms", "train_step.forward_ms",
                 "train_step.backward_ms", "train_step.optimizer_ms"):
        assert name not in m, name
    # the compared numbers come last in the result line
    assert [k for k in out if not k.startswith("_")][-1] == "checks"


def test_a_stretch_without_a_job_step_traces_the_step_after_the_close(
        monkeypatch):
    """Where the throttle grants the job no step in the traced stretch, the
    job's step after the close is traced for the train step's readers."""
    import time

    import torch

    from muxbench import bench
    from repro_torch.core.protection import KernelThrottle
    from repro_torch.obs import spans
    grant = KernelThrottle.should_launch

    def starved_while_traced(self, quantum=1.0):
        if spans._log is not None:
            self.refused += 1
            return False
        return grant(self, quantum)

    monkeypatch.setattr(KernelThrottle, "should_launch", starved_while_traced)
    torch.set_num_threads(1)
    parts = smoke_parts("danube-1.8b.share-poisson")
    parts["mix"]["mux"]["slo_slowdown"] = 100.0
    out = bench.run(parts, seed=SEED, seconds=1.5, trace=True,
                    t_process=time.perf_counter(), device="cpu")
    trace = [ln for ln in out["_lines"] if ln.startswith("[trace] ")]
    assert trace and " job_steps_traced=0 " in trace[0]
    joined = [ln for ln in out["_lines"] if ln.startswith("[spans] ")]
    assert joined and " train.forward:n=1," in joined[0]
    assert " train.optimizer:n=1," in joined[0]
    assert out["correct"] and out["failed"] == 0
    # the stretch's own readings still come from the window
    assert out["metrics"]["train_step_ms"]["value"] > 0
