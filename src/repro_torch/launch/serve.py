"""Online-serving entry point: the decode step MuxFlow protects, run through
the multiplexer, optionally space-shared with an offline AdamW train step of
a second copy of the same architecture (`--share`).  Port of
`repro/launch/serve.py`.

  PYTHONPATH=src python -m repro_torch.launch.serve [--arch xlstm-350m] \
      [--no-smoke] [--share] [--device cpu]

The default architecture is `repro`'s, xlstm-350m (the mLSTM pattern, whose
decode state is updated in place); every ported architecture can be served.
An encoder-decoder model (seamless-m4t-medium) decodes against a cross
cache of kv_cap source rows, as `repro`'s does; its `--share` raises, as
`repro`'s does, because the train step's token batches carry no source
embeddings (ROADMAP.md F6).

`--smoke/--no-smoke` chooses the SMOKE or the FULL config; `repro`'s parser
declared `--smoke` as `store_true` with default True, so FULL could not be
chosen there.  The multiplexer keeps `repro`'s quota settings
(`offline_state_bytes=0`, `MuxConfig.device_bytes` 16 GiB): `run` never
consults the quota, and 0.4 x 16 GiB would refuse h2o-danube-1.8b's 22 GB
of offline state if it did.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device, synchronize
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.multiplexer import Multiplexer, MuxConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import (init_cache, init_params, make_decode_step,
                                make_train_step)
from repro_torch.optim import AdamW, AdamWConfig


def run(arch: str, *, smoke: bool = True, requests: int = 200,
        qps: float = 40.0, share: bool = False, slo: float = 1.25,
        seed: int = 0, batch: int = 4, kv_cap: int = 128,
        device=None) -> dict:
    """Serve `requests` Poisson arrivals through the multiplexer; every
    online step is one timed decode step of the whole batch, every offline
    step (with `share`) one timed AdamW step of batch 4 x 32 tokens.
    Returns `repro`'s keys plus `decode_steps`, the decode steps run in
    all."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    decode = make_decode_step(cfg)
    cache = init_cache(cfg, batch, kv_cap,
                       src_len=kv_cap if cfg.enc_layers else 0, device=dev)
    toks = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    steps = [0]

    def timed_step(pos: int) -> float:
        synchronize(dev)
        t = time.perf_counter()
        decode(params, cache, toks, pos)
        synchronize(dev)
        steps[0] += 1
        return time.perf_counter() - t

    timed_step(0)                                   # warm up
    base_step = sum(timed_step(i) for i in range(1, 6)) / 5
    pos = [6]

    def online_fn(bs: int) -> float:
        dt = timed_step(pos[0] % (kv_cap - 1))
        pos[0] += 1
        return dt

    state = {}
    if share:
        opt = AdamW(AdamWConfig(lr=1e-3, total_steps=10_000))
        tparams = init_params(torch.Generator(device=dev).manual_seed(1), cfg)
        state = {"p": tparams, "o": opt.init(tparams.parameters()), "step": 0}
        train = make_train_step(cfg, opt)
        pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 4))

        def offline_fn() -> float:
            synchronize(dev)
            t = time.perf_counter()
            state["p"], state["o"], _ = train(state["p"], state["o"],
                                              pipe.batch_at(state["step"]))
            synchronize(dev)
            state["step"] += 1
            return time.perf_counter() - t

        offline_fn()                                # warm up
        off_step = offline_fn()                     # the offline microstep
    else:
        off_step = 1.0

        def offline_fn() -> float:
            return off_step

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, size=requests)).tolist()
    horizon = arrivals[-1] + 1.0
    mux = Multiplexer(online_fn, offline_fn, base_step, off_step,
                      MuxConfig(slo_slowdown=slo), offline_state_bytes=0)
    stats = mux.run(arrivals, horizon,
                    max_offline_steps=None if share else 0)
    return {"base_ms": base_step * 1e3, "p50_ms": stats.p50_ms,
            "p99_ms": stats.p99_ms, "served": stats.served,
            "offline_steps": stats.offline_steps,
            "offline_duty": stats.offline_duty, "oversold": stats.oversold,
            "train_steps_done": state.get("step", 0),
            "decode_steps": steps[0]}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="xlstm-350m")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--qps", type=float, default=40.0)
    ap.add_argument("--share", action="store_true")
    ap.add_argument("--slo", type=float, default=1.25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.arch, smoke=args.smoke, requests=args.requests,
              qps=args.qps, share=args.share, slo=args.slo,
              device=args.device)
    print(f"[serve] base={out['base_ms']:.2f}ms p50={out['p50_ms']:.2f}ms "
          f"p99={out['p99_ms']:.2f}ms served={out['served']} "
          f"offline_steps={out['offline_steps']} oversold={out['oversold']:.2f}")


if __name__ == "__main__":
    main()
