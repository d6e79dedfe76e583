"""Faults planted in the program under test, to show that the check
catches each: the run goes on as the benchmark's does, and its `correct`
must come out false.

  python3 muxbench/faults.py --workload NAME --fault F --seeds N [N ...]
      [--seconds S]

prints each seed's compared numbers (one JSON line a seed).  The faults
that begin with the first train step:
  * `train_state_unchanged`: the train step returns its weights and
    optimizer state unchanged;
  * `train_half_batch`: the train step's loss and gradient take the first
    half of the batch, the mean over those rows;
  * `decode_state_unchanged`: the decode step writes nothing into its
    cache;
  * `decode_half_batch`: the decode step's last half of the rows answer
    with the first half's logits;
  * `answer_altered`: the decode step's first row answers token 0.
And those that begin only after set-up, with the window's train steps
(the set-up steps, which the reference follows from the seed, stay
sound):
  * `late_train_state_unchanged`: the train step returns its weights and
    optimizer state unchanged;
  * `late_train_stale_batch`: every step trains on the last set-up
    step's batch, as a captured graph whose input is never refreshed
    would.
(A half batch from the window on is not caught: the window step's
gradient is not compared, `muxbench/sides/train_step.py` says why.)
The benchmark's own runs plant nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAULTS = ("train_state_unchanged", "train_half_batch",
          "decode_state_unchanged", "decode_half_batch", "answer_altered",
          "late_train_state_unchanged", "late_train_stale_batch")


@contextlib.contextmanager
def planted(fault: str, after: int = 0):
    """The program with `fault` planted; a `late_` fault acts from the
    train step numbered `after` on (the first is 0)."""
    import repro_torch.models as models
    import repro_torch.models.layers as layers
    import repro_torch.models.steps as steps
    from repro_torch.optim import AdamW
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    late = fault.startswith("late_")
    fault = fault.removeprefix("late_")
    start = after if late else 0
    calls = {"update": 0, "loss": 0}
    if fault == "train_state_unchanged":
        from repro_torch.optim.optimizer import global_norm
        update = AdamW.update

        def unchanged(self, params, grads, state):
            calls["update"] += 1
            if calls["update"] > start:
                return list(params), state, global_norm(grads)
            return update(self, params, grads, state)
        patch(AdamW, "update", unchanged)
    elif fault in ("train_half_batch", "train_stale_batch"):
        loss_fn = steps.loss_fn
        stale = {}

        def broken(params, cfg, batch):
            calls["loss"] += 1
            if calls["loss"] == start:
                stale.update(batch)
            if calls["loss"] <= start:
                return loss_fn(params, cfg, batch)
            if fault == "train_stale_batch":
                return loss_fn(params, cfg, stale)
            n = len(batch["tokens"]) // 2
            return loss_fn(params, cfg, {k: v[:n] for k, v in batch.items()})
        patch(steps, "loss_fn", broken)
    elif fault == "decode_state_unchanged":
        patch(layers, "write_rows", lambda *a: None)
    elif fault in ("decode_half_batch", "answer_altered"):
        make = models.make_decode_step

        def broken(cfg):
            decode = make(cfg)

            def step(params, cache, tokens, pos):
                logits, cache = decode(params, cache, tokens, pos)
                logits = logits.clone()
                if fault == "answer_altered":
                    logits[0, 0] = logits[0].max() + 1
                else:
                    n = len(logits) // 2
                    logits[n:2 * n] = logits[:n]
                return logits, cache
            return step
        patch(models, "make_decode_step", broken)
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from muxbench import bench
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    parts = bench.resolve(b, args.workload)
    after = parts["mix"]["offline"]["checked_steps"]
    for s in args.seeds:
        with planted(args.fault, after):
            out = bench.run(parts, seed=s, seconds=args.seconds
                            or b["run_seconds"], trace=False,
                            t_process=time.perf_counter())
        print(json.dumps({"seed": s, "fault": args.fault,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
