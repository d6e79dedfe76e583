"""The port's offline side: checkpoints (round trip, garbage collection, the
async writer), heartbeats against `repro`'s monitor, and the training
launcher against `repro`'s, including a run stopped through GracefulExit
and resumed from its checkpoint."""
import os
import signal

import numpy as np
import pytest
import torch

from repro.launch.train import run as jax_train_run
from repro.runtime.fault_tolerance import HeartbeatMonitor as JaxHeartbeat
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.launch import train
from repro_torch.runtime import HeartbeatMonitor, stale_mask

ARCH = "h2o-danube-1.8b"


def tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(tree_equal(x, y) for x, y in zip(a, b)))
    return a.dtype == b.dtype and torch.equal(a, b)


def sample_tree():
    """tests/test_infra.py's tree, with a list and fp32/bf16 leaves drawn
    from numpy (bf16 values that are not round numbers)."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    return {"w": w,
            "nested": ({"b": torch.from_numpy(rng.standard_normal(5).astype(
                np.float32)).to(torch.bfloat16)},
                torch.tensor(3, dtype=torch.int32)),
            "layers": [w.to(torch.bfloat16), [torch.arange(6.0)]]}


def test_checkpoint_roundtrip(tmp_path):
    tree = sample_tree()
    save(str(tmp_path), 7, tree)
    out, step = restore(str(tmp_path), tree, device="cpu")
    assert step == 7 and tree_equal(tree, out)
    assert out["nested"][0]["b"].dtype == torch.bfloat16


def test_checkpoint_gc_keeps_latest(tmp_path):
    tree = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, tree, keep=2)
    assert latest_step(str(tmp_path)) == 5
    steps = sorted(os.listdir(tmp_path))
    assert [s for s in steps if s.startswith("step_")] == \
        ["step_00000004", "step_00000005"]


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    tree = sample_tree()
    ck.save(3, tree)
    ck.wait()
    out, step = restore(str(tmp_path), tree, device="cpu")
    assert step == 3 and ck.last_saved == 3 and tree_equal(tree, out)


def test_restore_refuses_another_tree(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="tree structure"):
        restore(str(tmp_path), [torch.zeros(2), torch.zeros(2)], device="cpu")
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), {}, device="cpu")


def test_restore_refuses_a_leaf_of_another_shape_or_dtype(tmp_path):
    """A (4,) leaf restored against a (3, 4) one would broadcast into every
    row of the live weight; restore names the leaf instead."""
    save(str(tmp_path), 1, {"a": torch.zeros(2), "w": torch.arange(4.0)})
    with pytest.raises(ValueError, match=r"leaf 1: .*float32 \[4\].*\[3, 4\]"):
        restore(str(tmp_path), {"a": torch.zeros(2), "w": torch.zeros(3, 4)},
                device="cpu")
    with pytest.raises(ValueError, match="leaf 1: .*bfloat16"):
        restore(str(tmp_path), {"a": torch.zeros(2),
                                "w": torch.zeros(4, dtype=torch.bfloat16)},
                device="cpu")
    out, _ = restore(str(tmp_path), {"a": torch.ones(2), "w": torch.ones(4)},
                     device="cpu")
    assert torch.equal(out["w"], torch.arange(4.0))


def beat_history(mon_cls):
    """tests/test_infra.py:63-74's straggler and failure history."""
    hb = mon_cls(4, timeout_s=10.0, straggler_patience=3, now=0.0)
    for t in range(5):
        for n in (0, 1, 2):   # node 3 never beats
            hb.heartbeat(n, step_time=1.0 if n else 2.5, now=float(t))
    checks = [hb.check(now=9.0) for _ in range(3)]
    checks.append(hb.check(now=20.0))
    return checks


def test_heartbeat_failure_and_straggler_match_jax():
    got, want = beat_history(HeartbeatMonitor), beat_history(JaxHeartbeat)
    assert got == want
    assert 0 in got[2]["stragglers"] and 0 not in got[1]["stragglers"]
    assert got[-1]["dead"] == [0, 1, 2, 3]


def test_heartbeat_monitor_matches_stale_mask():
    """tests/test_infra.py:77-91: the monitor and the vectorised predicate
    agree, the boundary (exactly the timeout) counting as alive."""
    beats = [0.0, 10.0, 30.0, 50.0, 51.0, 100.0]
    dead = {}
    for cls in (HeartbeatMonitor, JaxHeartbeat):
        hb = cls(len(beats), timeout_s=50.0, now=0.0)
        for n, t in enumerate(beats):
            hb.heartbeat(n, now=t)
        dead[cls] = set(hb.check(now=100.0)["dead"])
    mask = stale_mask(100.0, np.asarray(beats), 50.0)
    assert dead[HeartbeatMonitor] == dead[JaxHeartbeat] == \
        set(np.flatnonzero(mask).tolist())
    assert 3 not in dead[HeartbeatMonitor]


def test_loss_decreases_in_short_training_like_jax():
    """tests/test_models.py:137-141's criterion, both launchers on the same
    arguments (the numbers' parity is the train-step tests')."""
    kw = dict(smoke=True, steps=25, batch=4, seq=32, lr=5e-3)
    out = train.run(ARCH, device="cpu", **kw)
    ref = jax_train_run(ARCH, **kw)
    assert set(out) == set(ref)
    for o in (out, ref):
        assert o["steps_done"] == 25 and not o["interrupted"]
        assert o["losses"][-1] < o["losses"][0] * 0.8


def test_graceful_exit_checkpoints_and_resumes(tmp_path, monkeypatch):
    """SIGTERM in step 6 of 12: the step finishes, the run saves step 7
    and stops; a second run resumes there.  The losses of the two runs are
    those of one uninterrupted run, bit for bit."""
    kw = dict(smoke=True, steps=12, batch=2, seq=32, lr=5e-3, device="cpu")
    whole = train.run(ARCH, **kw)

    class Interrupting(train.TokenPipeline):
        def batch_at(self, step):
            if step == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().batch_at(step)

    ckpt = str(tmp_path / "ckpt")
    with monkeypatch.context() as m:
        m.setattr(train, "TokenPipeline", Interrupting)
        first = train.run(ARCH, ckpt_dir=ckpt, ckpt_every=5, **kw)
    assert first["interrupted"] and first["steps_done"] == 7
    assert latest_step(ckpt) == 7
    second = train.run(ARCH, ckpt_dir=ckpt, ckpt_every=5, **kw)
    assert not second["interrupted"] and second["steps_done"] == 5
    assert first["losses"] + second["losses"] == whole["losses"]
    assert latest_step(ckpt) == 12


def test_train_cli_on_cpu(capsys):
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "16"])
    assert "[train] done: 2 steps" in capsys.readouterr().out
