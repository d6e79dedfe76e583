"""Where a decode step's time goes: host time, device time by kernel.

  PYTHONPATH=src python -m repro_torch.launch.profile --arch mistral-nemo-12b --no-smoke

Builds the model (random weights from a seed) and a cache of the serving
slice's shape (batch 8, capacity 4096; an encoder-decoder model's cross
cache of as many source rows), and decodes every slot at position
`--fill` - 1, so that each attention call reads `--fill` cache rows a
sequence.  It times 10 decode steps three ways: under `torch.profiler`
(device time of each kernel), the host clock around each of those steps
(ending in a synchronize; includes the profiler's cost), and CUDA events
around as many unprofiled steps (`step_ms`).  `idle_share` is
1 - device_ms / step_ms, the share of `step_ms` in which no kernel ran; it
is not clamped, so a negative value shows that the profiled kernel rows
overcount (overlapping kernels) or that the device time of the profiled
steps exceeds that of the unprofiled ones.  `decode_attention_ms_per_step`
is the device time of the decode-attention kernels (the split pass and,
where it runs, the merge).  For an MLA model, `mla_expand_ms_per_step` is
the device time (CUDA events, apart from the steps) of what each layer's
decode builds from the latent cache before the kernel: the keys and values
of its `--fill` rows (`layers.mla_expand`) and v zero-padded to the q.k
width, over every layer; `mla_expand_share` is its share of `step_ms`.
Prints one JSON object;
`--out` also writes it to a file.  Runs on the CUDA card only: a CPU run
would say nothing about the device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import init_cache, init_params, make_decode_step
from repro_torch.models import layers as L


def profile_decode(arch: str, *, smoke: bool, fill: int, batch: int = 8,
                   kv_cap: int = 4096, steps: int = 10, seed: int = 0,
                   top: int = 15) -> dict:
    dev = resolve_device(None)
    cfg = get_config(arch, smoke=smoke)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    # an encoder-decoder model decodes against a cross cache of kv_cap
    # source rows, as `launch.serve` sizes it
    cache = init_cache(cfg, batch, kv_cap,
                       src_len=kv_cap if cfg.enc_layers else 0, device=dev)
    decode = make_decode_step(cfg)
    toks = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    for _ in range(3):                                   # warm up
        decode(params, cache, toks, fill - 1)
    torch.cuda.synchronize()

    host_ms = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            t = time.perf_counter()
            decode(params, cache, toks, fill - 1)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t) * 1e3)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": ev.key, "calls": ev.count,
                         "device_ms_per_step": dev_us / 1e3 / steps})
    # operator rows (aten::*) include their kernels: keep kernel rows only
    kernels = sorted((r for r in rows if not r["name"].startswith("aten::")),
                     key=lambda r: -r["device_ms_per_step"])
    device_ms = sum(r["device_ms_per_step"] for r in kernels)
    # the port's decode attention: its split pass and, when it runs, merge
    attention_ms = sum(r["device_ms_per_step"] for r in kernels
                       if "decode_partial" in r["name"]
                       or "decode_combine" in r["name"])

    # steady state without the profiler: CUDA events around the steps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        decode(params, cache, toks, fill - 1)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / steps
    expand = {}
    if cfg.attn_kind == "mla":
        expand_ms = _mla_expand_ms(params, cfg, cache[0], fill, steps)
        expand = {"mla_expand_ms_per_step": expand_ms,
                  "mla_expand_share": expand_ms / step_ms}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    host_ms.sort()
    return {"arch": arch, "smoke": smoke, "batch": batch, "kv_cap": kv_cap,
            "fill": fill, "steps": steps, "card": smi.stdout.strip(),
            "step_ms": step_ms,
            "step_ms_host_median_profiled": host_ms[len(host_ms) // 2],
            "device_ms_per_step": device_ms,
            "idle_share": 1 - device_ms / step_ms,
            "decode_attention_ms_per_step": attention_ms, **expand,
            "top_kernels": kernels[:top]}


@torch.no_grad()
def _mla_expand_ms(params, cfg, cache: dict, fill: int, steps: int) -> float:
    """Device ms a step of building every layer's keys and padded values
    from the first `fill` rows of its latent cache, as the decode does."""
    dq = cfg.head_dim + cfg.rope_head_dim

    def build():
        for r, blk in enumerate(params.blocks):
            _, v = L.mla_expand(blk.attn, cache["ckv"][r][:, :fill],
                                cache["kr"][r][:, :fill], cfg)
            F.pad(v, (0, dq - v.shape[-1]))

    build()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        build()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mistral-nemo-12b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--fill", type=int, default=128)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = profile_decode(args.arch, smoke=args.smoke, fill=args.fill)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
