"""Offline-training launcher: the train step MuxFlow packs in beside online
serving.  Port of `repro/launch/train.py` for one device: AdamW, the
deterministic token pipeline, async atomic checkpoints with resume from the
latest, graceful exit on SIGTERM/SIGINT (checkpoint, then stop: the paper's
§4.2 mechanism), and heartbeats.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --no-smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

`--smoke/--no-smoke` chooses the SMOKE or the FULL config.  The token
pipeline's batches carry tokens only, so an encoder-decoder model
(seamless-m4t-medium) raises at its first step, as `repro`'s launcher does
(ROADMAP.md F6).

Over a mesh (`run(..., mesh_shape=(data, model))`, as `repro`'s): the
parameters, the AdamW moments and each batch are DTensors placed by the
sharding rules (FSDP x TP) under `activation_mesh`, and a resume restores
the checkpoint onto this mesh through `restore(..., shardings=)`, whatever
mesh wrote it.  The launcher initialises no process group itself: a caller
that passes a mesh shape owns one (NCCL on the card, gloo on the CPU, one
process a device), and within an initialised group the default mesh is
(world size, 1) over ("data", "model").  One process with no group runs
meshless.  `repro`'s CLI has no mesh flag, and neither has this one.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.errors import GracefulExit
from repro_torch.data import DataConfig, TokenPipeline, global_batch_to_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params, make_train_step
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import HeartbeatMonitor
from repro_torch.sharding import (activation_mesh, batch_sharding,
                                  opt_state_sharding, param_sharding)
from repro_torch.sharding.rules import distribute_params, distribute_tree


def _full(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def run(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
        seq: int = 64, lr: float = 3e-3, ckpt_dir: str | None = None,
        ckpt_every: int = 20, microbatches: int = 1, log_every: int = 10,
        resume: bool = True, device=None, mesh_shape=None) -> dict:
    """Train for `steps` steps (from the latest checkpoint under `ckpt_dir`
    when `resume`).  Returns {"losses", "final_loss", "steps_done",
    "interrupted"}, the losses of the steps this call ran.  `mesh_shape`
    (data, model) needs an initialised process group of that many
    processes; see the module's docstring."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    opt = AdamW(AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                            total_steps=steps))
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    mesh = None
    if mesh_shape is None and dist.is_initialized():
        mesh_shape = (dist.get_world_size(), 1)
    if mesh_shape is not None:
        mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    scope = (activation_mesh(mesh) if mesh is not None
             else contextlib.nullcontext())
    with scope:
        return _train(cfg, params, opt, mesh, dev, steps=steps, batch=batch,
                      seq=seq, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      microbatches=microbatches, log_every=log_every,
                      resume=resume)


def _train(cfg, params, opt, mesh, dev, *, steps, batch, seq, ckpt_dir,
           ckpt_every, microbatches, log_every, resume) -> dict:
    p_specs = o_specs = None
    if mesh is not None:
        p_specs = param_sharding(mesh, params, mode="train")
        distribute_params(params, mesh, p_specs)
    weights = list(params.parameters())
    opt_state = opt.init(weights)
    if mesh is not None:
        o_specs = opt_state_sharding(mesh, p_specs, opt_state)
        opt_state = distribute_tree(opt_state, mesh, o_specs,
                                    src_data_rank=None)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, seq, batch))
    step_fn = make_train_step(cfg, opt, microbatches=microbatches)

    start = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and resume and latest_step(ckpt_dir) is not None:
        shardings = (None if mesh is None
                     else (list(p_specs.values()), o_specs))
        (saved, opt_state), start = restore(ckpt_dir, (weights, opt_state),
                                            device=dev, shardings=shardings)
        with torch.no_grad():
            for w, s in zip(weights, saved):
                w.copy_(s)
        print(f"[train] resumed from step {start}")

    hb = HeartbeatMonitor(1)
    losses = []
    interrupted = False

    def on_checkpoint():
        nonlocal interrupted
        interrupted = True

    gex = GracefulExit(on_checkpoint=on_checkpoint)
    t0 = time.time()
    with gex:
        for step in range(start, steps):
            data = pipe.batch_at(step)
            if mesh is not None:
                data = global_batch_to_device(
                    data, batch_sharding(mesh, data), device=dev)
            params, opt_state, metrics = step_fn(params, opt_state, data)
            loss = float(_full(metrics["loss"]))
            losses.append(loss)
            hb.heartbeat(0, step_time=time.time() - t0)
            if step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({(time.time()-t0)/(step-start+1)*1e3:.0f} ms/step)",
                      flush=True)
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, (weights, opt_state))
            if interrupted:
                print("[train] SIGTERM/SIGINT: graceful exit, checkpointing")
                break
    if ckpt:
        # graceful exit persists progress before releasing the device
        ckpt.wait()
        if interrupted or steps % ckpt_every:
            ckpt.save(steps if not interrupted else step + 1,
                      (weights, opt_state))
            ckpt.wait()
        if mesh is not None:
            dist.barrier()      # rank 0's write is done before any rank goes on
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "steps_done": len(losses), "interrupted": interrupted}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="xlstm-350m")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
              seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, microbatches=args.microbatches,
              device=args.device)
    print(f"[train] done: {out['steps_done']} steps, "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
