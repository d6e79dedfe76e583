"""End-to-end example on the PyTorch port: serve a model with batched requests
while an offline training job space-shares the same device under MuxFlow
protection.

Real PyTorch compute on the CUDA card (or on the CPU with ``--device
cpu``): the online workload is the decode step of h2o-danube-1.8b (batched
requests, Poisson arrivals) through the port's `decode_attention` kernel;
the offline workload is the AdamW train step of granite-moe-1b-a400m.  Both
are the SMOKE configs by default, as the original's; ``--no-smoke`` runs
them at full width.  The multiplexer's PID holds the online latency inside
the SLO while harvesting idle quanta for training — the xCUDA/dynamic-SM
mechanism at step granularity.

The §4.2 signal path is demonstrated end-to-end: a GracefulExit harness with
real checkpoint/release callbacks is installed on the multiplexer, and a
timer sends this process an actual SIGINT mid-run — the handler freezes
kernel launches (no more offline microsteps), checkpoints the training
state, and releases resources while the online workload keeps serving.
Ctrl-C exercises the same path by hand.

  PYTHONPATH=src python examples/torch_serve_multiplex.py [--no-smoke] \
      [--n-req 150] [--device cpu]

The port of `examples/serve_multiplex.py`: the same workloads, batch,
capacity, arrivals, SLO, callbacks and timer, and the same printed lines.
`main(smoke=True, n_req=150, device=None)` takes as keyword arguments what
the original fixed (SMOKE and 150 requests are its values) and returns what
it prints as a dict, with the decode calls it made (the warm-up's
included), the offline and online steps begun after the signal, and the
wall second at which the signal landed.  One difference from the original
comes with PyTorch: the checkpoint callback's stand-in snapshot
(`ckpt["params"]`) is the live module, which the optimizer updates in
place, not an immutable array as in JAX; a step in flight when the signal
lands (the handler runs between bytecodes of the main thread) finishes
after the callback.
"""
import argparse
import os
import signal
import threading
import time

import torch

from repro_torch import resolve_device, synchronize
from repro_torch.configs import get_config
from repro_torch.core.errors import GracefulExit
from repro_torch.core.multiplexer import Multiplexer, MuxConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import (init_cache, init_params, make_decode_step,
                                make_train_step)
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.serving_plane import ArrivalProcess


def main(*, smoke: bool = True, n_req: int = 150, device=None) -> dict:
    dev = resolve_device(device)
    # ---- online: danube decode over a standing KV cache
    on_cfg = get_config("h2o-danube-1.8b", smoke=smoke)
    on_params = init_params(torch.Generator(device=dev).manual_seed(0),
                            on_cfg)
    decode = make_decode_step(on_cfg)
    BATCH, CAP = 8, 128
    cache = init_cache(on_cfg, BATCH, CAP, device=dev)
    toks = torch.zeros((BATCH, 1), dtype=torch.long, device=dev)
    decode_calls = [0]

    def decode_at(pos: int) -> None:
        decode(on_params, cache, toks, pos)
        decode_calls[0] += 1

    decode_at(0)
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(1, 9):
        decode_at(i)
    synchronize(dev)
    base_step = (time.perf_counter() - t0) / 8
    print(f"online decode step (batch {BATCH}): {base_step*1e3:.2f} ms")

    # ---- offline: granite-MoE training
    off_cfg = get_config("granite-moe-1b-a400m", smoke=smoke)
    opt = AdamW(AdamWConfig(lr=3e-3, total_steps=100_000))
    state = {"p": init_params(torch.Generator(device=dev).manual_seed(1),
                              off_cfg)}
    state["o"] = opt.init(state["p"].parameters())
    train = make_train_step(off_cfg, opt)
    pipe = TokenPipeline(DataConfig(off_cfg.vocab_size, 64, 8))
    state["p"], state["o"], m = train(state["p"], state["o"], pipe.batch_at(0))
    synchronize(dev)
    t0 = time.perf_counter()
    state["p"], state["o"], m = train(state["p"], state["o"], pipe.batch_at(1))
    synchronize(dev)
    off_step = time.perf_counter() - t0
    losses = [float(m["loss"])]
    step_i = [2]
    print(f"offline train microstep: {off_step*1e3:.2f} ms")

    pos = [9]
    online_steps = [0]
    after_signal = {"offline": 0, "online": 0}
    run_start = [0.0]

    def count_if_signalled(side: str) -> None:
        if mux.graceful.triggered is not None:
            after_signal[side] += 1

    def online_fn(bs: int) -> float:
        count_if_signalled("online")
        t = time.perf_counter()
        decode_at(pos[0] % (CAP - 1))
        synchronize(dev)
        pos[0] += 1
        online_steps[0] += 1
        return time.perf_counter() - t

    def offline_fn() -> float:
        count_if_signalled("offline")
        t = time.perf_counter()
        state["p"], state["o"], m = train(state["p"], state["o"],
                                          pipe.batch_at(step_i[0]))
        synchronize(dev)
        losses.append(float(m["loss"]))
        step_i[0] += 1
        return time.perf_counter() - t

    # arrival rate sized so the device is ~half-loaded by online traffic;
    # the latency budget absorbs at most one offline microstep of queueing
    # (the paper: latency demands >100ms, a ~10ms share-slowdown is fine).
    # Same seeded ArrivalProcess the sim and profiler consume — one
    # definition of "requests arrive" across the repo.
    process = ArrivalProcess.poisson(
        mean_gap=max(base_step * 2.0, off_step * 1.2), seed=0)
    arrivals = process.first_n(n_req).tolist()
    horizon = arrivals[-1] + 0.5
    budget = base_step * 2 + off_step * 2.5
    print(f"\nserving {n_req} request batches over ~{horizon:.1f}s; "
          f"latency budget {budget*1e3:.0f}ms; offline fills the slack...")
    mux = Multiplexer(online_fn, offline_fn, base_step, off_step,
                      MuxConfig(slo_slowdown=1.25, latency_budget_s=budget))

    # ---- §4.2 graceful exit, wired end-to-end: freeze -> checkpoint ->
    # release, driven by a *real* signal delivered mid-run
    ckpt: dict = {}
    released: list[float] = []

    def on_checkpoint() -> None:
        ckpt["step"] = step_i[0]
        ckpt["loss"] = losses[-1]
        ckpt["params"] = state["p"]          # persisted snapshot stand-in
        ckpt["wall_s"] = time.perf_counter() - run_start[0]
        ckpt["online_steps"] = online_steps[0]

    def on_release() -> None:
        released.append(time.perf_counter())  # CUDA-context release analogue

    mux.graceful = GracefulExit(throttle=mux.throttle,
                                on_checkpoint=on_checkpoint,
                                on_release=on_release)
    # deliver SIGINT partway through serving (Ctrl-C does the same by hand)
    killer = threading.Timer(horizon * 0.5,
                             lambda: os.kill(os.getpid(), signal.SIGINT))
    killer.daemon = True
    run_start[0] = time.perf_counter()
    killer.start()
    s = mux.run(arrivals, horizon)
    killer.cancel()
    run_wall = time.perf_counter() - run_start[0]
    print(f"\nonline : served={s.served} p50={s.p50_ms:.2f}ms "
          f"p99={s.p99_ms:.2f}ms (base {s.base_ms:.2f}ms)")
    print(f"offline: {s.offline_steps} train steps "
          f"(loss {losses[0]:.3f} -> {losses[-1]:.3f}), "
          f"duty={s.offline_duty:.2f}, oversold={s.oversold:.2f}")
    print(f"safety : evicted={s.evicted}, slo_violations={s.slo_violations}")
    gex = mux.graceful
    if gex.triggered is not None:
        print(f"graceful exit: caught {gex.triggered.value} -> froze kernel "
              f"launches (frozen={mux.throttle.frozen}), checkpointed at "
              f"step {ckpt.get('step')} (loss {ckpt.get('loss', 0.0):.3f}), "
              f"released context ({len(released)} release callback)")
        print("online kept serving after the signal: errors propagated = 0")
    else:
        print("graceful exit: signal did not arrive before the horizon "
              "(run was too short); Ctrl-C exercises the same path")
    return {
        "smoke": smoke, "n_req": n_req, "base_ms": s.base_ms,
        "offline_step_ms": off_step * 1e3, "horizon_s": horizon,
        "budget_ms": budget * 1e3, "served": s.served, "p50_ms": s.p50_ms,
        "p99_ms": s.p99_ms, "offline_steps": s.offline_steps,
        "loss_first": losses[0], "loss_last": losses[-1],
        "offline_duty": s.offline_duty, "oversold": s.oversold,
        "evicted": s.evicted, "slo_violations": s.slo_violations,
        "triggered": None if gex.triggered is None else gex.triggered.value,
        "frozen": mux.throttle.frozen, "checkpoint_step": ckpt.get("step"),
        "checkpoint_loss": ckpt.get("loss"), "releases": len(released),
        "signal_wall_s": ckpt.get("wall_s"),
        "online_steps_at_signal": ckpt.get("online_steps"),
        "offline_steps_after_signal": after_signal["offline"],
        "online_steps_after_signal": after_signal["online"],
        "online_steps": online_steps[0], "decode_calls": decode_calls[0],
        "run_wall_s": run_wall}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--n-req", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(smoke=args.smoke, n_req=args.n_req, device=args.device)
