"""Offline-workload example on the PyTorch port: train a small LM for a few
hundred steps with checkpointing, then kill-and-resume to demonstrate the
evict/restart path the MuxFlow scheduler relies on.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \
      [--device cpu]

The port of `examples/train_lm.py`: the same phases, printed lines and
check.  It trains on the CUDA card (or on the CPU with ``--device cpu``).
`main` takes the command line as a list and returns both phases' results
and the step the second resumed from.
"""
import argparse
import shutil
import tempfile

from repro_torch.checkpoint import latest_step
from repro_torch.launch.train import run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    ckpt = tempfile.mkdtemp(prefix="muxflow_ckpt_")
    try:
        half = args.steps // 2
        print(f"== phase 1: train to step {half} (then simulate eviction) ==")
        out1 = run(args.arch, smoke=True, steps=half, batch=8, seq=64,
                   lr=3e-3, ckpt_dir=ckpt, ckpt_every=25, device=args.device)
        resumed_from = latest_step(ckpt)
        print(f"   evicted at step {half}, checkpoint at "
              f"step {resumed_from}")
        print("== phase 2: restart from checkpoint, finish the job ==")
        out2 = run(args.arch, smoke=True, steps=args.steps, batch=8, seq=64,
                   lr=3e-3, ckpt_dir=ckpt, ckpt_every=25, resume=True,
                   device=args.device)
        print(f"\nloss: start {out1['losses'][0]:.3f} -> "
              f"pre-evict {out1['final_loss']:.3f} -> "
              f"final {out2['final_loss']:.3f}")
        assert out2["final_loss"] < out1["losses"][0]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"phase1": out1, "phase2": out2, "resumed_from": resumed_from}


if __name__ == "__main__":
    main()
