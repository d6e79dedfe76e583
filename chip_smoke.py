#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    every kernel under src/repro_torch/kernels/csrc, built by nvcc;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shape and the test shapes, fp32 and bf16;
  4. parity   mistral-nemo-12b SMOKE in fp32: the model on the card (through
              the kernel) against the same weights on the CPU (plain path):
              decode logits, then the serving engine's greedy tokens;
  5. serve    mistral-nemo-12b FULL in bf16: `launch.serve.run` at batch 8,
              kv_cap 4096, then a ServingEngine with 8 slots answering ragged
              requests; the kernel's launch count must be 40 per decode step;
  6. timing   each kernel, its plain version and the library call that
              computes the same function, at the main path's shape.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM, NVIDIA's data sheet (dense, at the full 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

MAIN = dict(B=8, Skv=4096, H=32, Hk=8, d=128)     # mistral-nemo-12b decode
RAGGED = [1, 17, 512, 1000, 2048, 3000, 4095, 4096]
# (B, Skv, H, Hk, d, kv_len): tests/test_kernels.py's decode sweep, then the
# other template paths of the kernel (d > 128 with G = 8; d = 24 with G = 3)
# and the SMOKE head width
EXTRA_SHAPES = [
    (2, 256, 4, 2, 128, 200),
    (1, 512, 8, 1, 128, 512),
    (3, 256, 4, 4, 128, 17),
    (2, 300, 16, 2, 256, [7, 300]),
    (2, 100, 6, 2, 24, [1, 99]),
    (4, 64, 4, 2, 16, [1, 5, 33, 64]),
]


class PhaseFailed(RuntimeError):
    pass


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def compare(torch, out, want, atol: float, rtol: float) -> float:
    """Max abs error; fails unless |out - want| <= atol + rtol*|want|
    everywhere (numpy's assert_allclose rule)."""
    out, want = out.float(), want.float()
    require(bool(torch.isfinite(out).all()), "non-finite output")
    err = (out - want).abs()
    bad = err > atol + rtol * want.abs()
    require(not bool(bad.any()),
            f"{int(bad.sum())} values off by more than {atol} + {rtol}*|want| "
            f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("1/6 device", kind=repr(kind), count=torch.cuda.device_count(),
          capability=torch.cuda.get_device_capability(0),
          torch=torch.__version__, cuda=torch.version.cuda)
    return kind


def phase_build() -> None:
    from repro_torch.kernels import _build
    t = time.perf_counter()
    paths = _build.build(*_build.sources())
    for name in paths:
        _build.load(name)
    phase("2/6 build", kernels=",".join(paths),
          seconds=f"{time.perf_counter() - t:.1f}")


def phase_kernels(torch) -> float:
    """Returns the max abs error at the main path's shape in bf16.

    The kernel computes in fp32 whatever its input type, so it is held
    against the plain version run in fp32 on the same inputs: within 2e-5
    (atol and rtol), and for a bf16 output also its one rounding to bf16,
    at most half an ulp (2**-8 of the value)."""
    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rtol = {torch.float32: 2e-5, torch.bfloat16: 2e-5 + 2**-8}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    main_err = 0.0
    cases = [((MAIN["B"], MAIN["Skv"], MAIN["H"], MAIN["Hk"], MAIN["d"]), kv)
             for kv in (RAGGED, 3000)]
    cases += [(s[:5], s[5]) for s in EXTRA_SHAPES]
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for i, ((B, Skv, H, Hk, d), kv_len) in enumerate(cases):
            q = torch.randn(B, 1, H, d, generator=gen, device=dev).to(dtype)
            # a cache with room for 2*Hk heads, read as its first Hk: the
            # kernel must follow the strides of a non-contiguous view
            big = torch.randn(2, B, Skv, 2 * Hk, d, generator=gen,
                              device=dev).to(dtype)
            k, v = big[0][:, :, :Hk], big[1][:, :, :Hk]
            lens = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
                    if isinstance(kv_len, list) else kv_len)
            out = da.decode_attention_cuda(q, k, v, lens)
            torch.cuda.synchronize()
            want = da.decode_attention_plain(q.float(), k.float(), v.float(),
                                             lens)
            err = compare(torch, out, want, 2e-5, rtol[dtype])
            worst[dtype] = max(worst[dtype], err)
            if i < 2 and dtype == torch.bfloat16:
                main_err = max(main_err, err)
            n += 1
    phase("3/6 kernels", cases=n, max_abs_err_bf16=f"{worst[torch.bfloat16]:.3e}",
          max_abs_err_fp32=f"{worst[torch.float32]:.3e}",
          tol="atol:2e-5,rtol:fp32=2e-5,bf16=2e-5+2**-8",
          against="plain_in_fp32")
    return main_err


def phase_parity(torch) -> None:
    import copy

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params, make_decode_step
    from repro_torch.serving.engine import (EngineConfig, ServeRequest,
                                            ServingEngine)
    cfg = get_config("mistral-nemo-12b", smoke=True, dtype=torch.float32)
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = copy.deepcopy(cpu).to("cuda")
    decode = make_decode_step(cfg)
    B, cap = 4, 64
    caches = {"cpu": init_cache(cfg, B, cap, device="cpu"),
              "cuda": init_cache(cfg, B, cap, device="cuda")}
    rng = np.random.default_rng(0)
    start = np.array([0, 3, 10, 40])
    worst = 0.0
    for step in range(6):
        toks = rng.integers(0, cfg.vocab_size, (B, 1))
        pos = start + step
        want, _ = decode(cpu, caches["cpu"], torch.from_numpy(toks),
                         torch.from_numpy(pos))
        got, _ = decode(gpu, caches["cuda"], torch.from_numpy(toks).cuda(),
                        torch.from_numpy(pos))
        worst = max(worst, compare(torch, got.cpu(), want, 1e-4, 1e-4))

    def serve(params):
        r = np.random.default_rng(1)
        reqs = [ServeRequest(i, r.integers(0, cfg.vocab_size,
                                           int(r.integers(2, 9))),
                             max_new_tokens=int(r.integers(2, 6)))
                for i in range(6)]
        eng = ServingEngine(cfg, params, EngineConfig(num_slots=3,
                                                      kv_capacity=64))
        for req in reqs:
            eng.submit(req)
        eng.drain()
        return [req.output for req in reqs]

    require(serve(gpu) == serve(cpu), "engine tokens differ: card vs CPU")
    phase("4/6 parity", config="mistral-nemo-12b/SMOKE/fp32",
          logits_max_abs_err=f"{worst:.3e}", tol="1e-4",
          engine_tokens="equal")


def phase_serve(torch) -> dict:
    """The main path.  Returns the kernels' launch counts of this run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.serve import run
    from repro_torch.models import init_params, make_decode_step
    from repro_torch.serving.engine import (EngineConfig, ServeRequest,
                                            ServingEngine)
    cfg = get_config("mistral-nemo-12b", smoke=False)
    require(cfg.num_layers == 40 and cfg.d_model == 5120, "not FULL")

    da.launches = 0
    t = time.perf_counter()
    res = run("mistral-nemo-12b", smoke=False, batch=8, kv_cap=4096,
              device="cuda")
    wall = time.perf_counter() - t
    run_launches = da.launches
    require(run_launches == cfg.num_layers * res["decode_steps"],
            f"run: {run_launches} launches for {res['decode_steps']} steps")
    phase("5/6 serve.run", base_ms=res["base_ms"], p50_ms=res["p50_ms"],
          p99_ms=res["p99_ms"], served=res["served"],
          decode_steps=res["decode_steps"], launches=run_launches,
          wall_s=f"{wall:.1f}")
    gc.collect()
    torch.cuda.empty_cache()

    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServingEngine(cfg, params, EngineConfig(num_slots=8,
                                                  kv_capacity=4096))
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(i, rng.integers(0, cfg.vocab_size,
                                         int(rng.integers(8, 65))),
                         max_new_tokens=16) for i in range(8)]
    for req in reqs:
        eng.submit(req)
    da.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    eng_launches = da.launches
    require(eng_launches == cfg.num_layers * eng.steps,
            f"engine: {eng_launches} launches for {eng.steps} steps")
    new = sum(len(r.output) for r in reqs)
    require(new == 16 * len(reqs) and all(
        0 <= tok < cfg.vocab_size for r in reqs for tok in r.output),
        "engine output has the wrong length or ids out of the vocabulary")
    # the logits of one more step at full width: right shape, finite
    logits, _ = make_decode_step(cfg)(
        params, eng.cache, torch.zeros((8, 1), dtype=torch.long,
                                       device="cuda"), 100)
    require(tuple(logits.shape) == (8, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()), "bad full-width logits")
    phase("5/6 serve.engine", requests=len(reqs), decode_steps=eng.steps,
          new_tokens=new, tokens_per_s=f"{new / wall:.1f}",
          wall_s=f"{wall:.2f}", launches=eng_launches,
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"decode_attention": run_launches + eng_launches}


def phase_timing(torch, launches: dict, max_err: float) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, Skv, H, Hk, d = (MAIN[k] for k in ("B", "Skv", "H", "Hk", "d"))
    dtype = torch.bfloat16
    q = torch.randn(B, 1, H, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
    kv_len = Skv                                  # the full cache
    lens = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
    saved = da.launches
    ms = time_ms(torch, lambda: da.decode_attention_cuda(q, k, v, lens))
    plain_ms = time_ms(torch, lambda: da.decode_attention_plain(q, k, v, lens))
    da.launches = saved                  # launches to time do not count
    # yardstick only, never called by the port: one SDPA call, GQA, masked
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(Skv, device=dev)[None] < lens[:, None])[:, None, None]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    library_err = float((sdpa().transpose(1, 2).float() - da.decode_attention_plain(
        q, k, v, lens).float()).abs().max())
    library_ms = time_ms(torch, sdpa)
    item = q.element_size()
    nbytes = (2 * B * kv_len * Hk * d + 2 * B * H * d) * item + 4 * B
    flops = 4 * B * H * kv_len * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS["bfloat16"]
    row = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention.py:63",
           "launches": launches["decode_attention"], "max_abs_err": max_err,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    phase("6/6 timing", shape=f"B{B}_Skv{Skv}_H{H}_Hk{Hk}_d{d}_bf16_kvlen{kv_len}",
          ms=ms, plain_ms=plain_ms, library_ms=library_ms,
          library_max_abs_err=f"{library_err:.3e}", bound_ms=row["bound_ms"])
    return [row]


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = phase_device(torch)
    phase_build()
    max_err = phase_kernels(torch)
    phase_parity(torch)
    launches = phase_serve(torch)
    missing = [name for name, n in launches.items() if n == 0]
    require(not missing, f"kernels never launched on the main path: {missing}")
    kernels = phase_timing(torch, launches, max_err)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
