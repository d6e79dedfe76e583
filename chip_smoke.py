#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (or more); any failure raises and exits non-zero:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    every kernel under src/repro_torch/kernels/csrc, one nvcc each,
              all started together;
  3. kernels  each kernel against its plain PyTorch version run in fp32 on
              the same inputs, on the card: the test sweeps, the profiling
              catalog's shapes and full width (decode: mistral-nemo-12b at
              B8/Skv4096; flash: mistral-nemo-12b prefill at S4096 and
              h2o-danube-1.8b's window at S8192; ssm: jamba-1.5-large's
              Mamba layer, di 16384, N 16, S4096);
  4. parity   mistral-nemo-12b SMOKE in fp32: the model on the card (through
              the kernel) against the same weights on the CPU (plain path):
              decode logits, then the serving engine's greedy tokens;
  5. serve    mistral-nemo-12b FULL in bf16: `launch.serve.run` at batch 8,
              kv_cap 4096, then a ServingEngine with 8 slots answering ragged
              requests; the kernel's launch count must be 40 per decode step;
  6. profile  MuxFlow's measurement loop on the card: the smoke suite's speed
              matrix (as `python -m repro_torch profile` builds it), schema
              clean and equal to the CPU-built matrix but for checksums,
              which agree within a stated tolerance; all three kernels must
              launch; then the measured speed predictor trained on the card;
  7. train    three momentum-SGD steps of xlstm-350m FULL in bf16 (batch 2,
              seq 512): finite losses, step time, peak memory;
  8. timing   each kernel, its plain version and the library call that
              computes the same function (where one exists), at full width.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing any result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM, NVIDIA's data sheet (dense, at the full 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# exponentials on the SFU: 16 results a clock a SM (CUDA programming guide,
# arithmetic throughput, compute capability 9.0) x 132 SMs x 1.98 GHz, the
# boost clock behind the 67 TFLOP/s fp32 peak (132 x 128 FMA x 2 x 1.98 GHz)
PEAK_EXP_S = 16 * 132 * 1.98e9

MAIN = dict(B=8, Skv=4096, H=32, Hk=8, d=128)     # mistral-nemo-12b decode
RAGGED = [1, 17, 512, 1000, 2048, 3000, 4095, 4096]
# (B, Sq, Skv, H, Hk, d, causal, window): tests/test_kernels.py:20-26, the
# catalog's flash-prefill, ragged tiles at d 80, a window without causal, d 256
FLASH_SHAPES = [
    (1, 128, 128, 1, 1, 128, True, None),
    (2, 256, 256, 4, 2, 128, True, None),
    (2, 128, 256, 4, 4, 128, False, None),
    (1, 256, 256, 8, 2, 128, True, 128),
    (2, 384, 384, 2, 1, 128, True, 256),
    (1, 128, 128, 4, 2, 64, True, None),
    (1, 200, 300, 4, 2, 80, True, None),
    (2, 100, 100, 6, 2, 24, False, 50),
    (1, 64, 64, 2, 1, 256, True, None),
]
FLASH_MAIN = (1, 4096, 4096, 32, 8, 128, True, None)   # mistral-nemo-12b
FLASH_DANUBE = (1, 8192, 8192, 32, 8, 80, True, 4096)  # h2o-danube-1.8b
# (B, S, di, N): tests/test_kernels.py:58-62, the catalog's ssm-scan, ragged
SSM_SHAPES = [(1, 64, 128, 16), (2, 128, 256, 16), (2, 96, 128, 8),
              (2, 64, 128, 8), (1, 100, 70, 4)]
SSM_MAIN = (1, 4096, 16384, 16)                        # jamba-1.5-large Mamba
SSM_TOL = 1e-4                                         # tests/test_kernels.py:73

# (B, Skv, H, Hk, d, kv_len): tests/test_kernels.py's decode sweep, the
# catalog's decode-serve, then the other template paths of the kernel
# (d > 128 with G = 8; d = 24 with G = 3) and the SMOKE head width
EXTRA_SHAPES = [
    (2, 256, 4, 2, 128, 200),
    (1, 512, 8, 1, 128, 512),
    (3, 256, 4, 4, 128, 17),
    (4, 256, 4, 2, 64, 224),
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


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """(least ms for the work, what sets it): bytes over the memory rate,
    or the slowest of the operation counts over their peak rates."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = max(n / rate for n, rate in ops.values())
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


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
    phase("1/8 device", kind=repr(kind), count=torch.cuda.device_count(),
          capability=torch.cuda.get_device_capability(0),
          torch=torch.__version__, cuda=torch.version.cuda)
    return kind


def phase_build() -> None:
    from repro_torch.kernels import _build
    t = time.perf_counter()
    paths = _build.build(*_build.sources())
    for name in paths:
        _build.load(name)
    phase("2/8 build", kernels=",".join(paths),
          seconds=f"{time.perf_counter() - t:.1f}")


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version; returns each kernel's max abs
    error at its full-width, timed shape."""
    return {"decode_attention": check_decode(torch),
            "flash_attention": check_flash(torch),
            "ssm_scan": check_ssm(torch)}


def check_decode(torch) -> float:
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
    catalog = {}                  # the profile path's decode-serve shape
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
            if (B, Skv, H, Hk, d, kv_len) == (4, 256, 4, 2, 64, 224):
                catalog[str(dtype).split(".")[1]] = err
            n += 1
    require(len(catalog) == 2, "the catalog's decode shape was not checked")
    phase("3/8 kernels", kernel="decode_attention", cases=n,
          max_abs_err_bf16=f"{worst[torch.bfloat16]:.3e}",
          max_abs_err_fp32=f"{worst[torch.float32]:.3e}",
          max_abs_err_catalog_B4_Skv256_d64_fp32=f"{catalog['float32']:.3e}",
          max_abs_err_catalog_B4_Skv256_d64_bf16=f"{catalog['bfloat16']:.3e}",
          tol="atol:2e-5,rtol:fp32=2e-5,bf16=2e-5+2**-8",
          against="plain_in_fp32")
    return main_err


def check_flash(torch) -> float:
    """The flash kernel against the plain version run in fp32 on the same
    inputs, under decode's rule; K and V are strided views.  The plain
    version runs one KV head's query heads at a time (the heads are
    independent): over all 32 heads at S 8192 it would hold 8.6 GB of fp32
    scores several times over.  Returns the error at FLASH_MAIN in bf16."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rtol = {torch.float32: 2e-5, torch.bfloat16: 2e-5 + 2**-8}
    cases = [(s, dt) for s in FLASH_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(FLASH_MAIN, torch.bfloat16), (FLASH_MAIN, torch.float32),
              (FLASH_DANUBE, torch.bfloat16)]
    errs = {}
    for shape, dtype in cases:
        B, Sq, Skv, H, Hk, d, causal, window = shape
        q = torch.randn(B, Sq, H, d, generator=gen, device=dev).to(dtype)
        big = torch.randn(2, B, Skv, 2 * Hk, d, generator=gen,
                          device=dev).to(dtype)
        k, v = big[0][:, :, :Hk], big[1][:, :, :Hk]
        out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        G, err = H // Hk, 0.0
        for g in range(Hk):
            hs = slice(g * G, (g + 1) * G)
            want = fa.flash_attention_plain(
                q[:, :, hs].float(), k[:, :, g:g + 1].float(),
                v[:, :, g:g + 1].float(), causal=causal, window=window)
            err = max(err, compare(torch, out[:, :, hs], want, 2e-5,
                                   rtol[dtype]))
        errs[(shape, str(dtype).split(".")[1])] = err
        del q, big, k, v, out
    torch.cuda.empty_cache()
    small = [e for (s, _), e in errs.items() if s in FLASH_SHAPES]
    phase("3/8 kernels", kernel="flash_attention", cases=len(errs),
          max_abs_err_sweep=f"{max(small):.3e}",
          max_abs_err_mistral_S4096_bf16=f"{errs[(FLASH_MAIN, 'bfloat16')]:.3e}",
          max_abs_err_mistral_S4096_fp32=f"{errs[(FLASH_MAIN, 'float32')]:.3e}",
          max_abs_err_danube_S8192_w4096_bf16=
          f"{errs[(FLASH_DANUBE, 'bfloat16')]:.3e}",
          tol="atol:2e-5,rtol:fp32=2e-5,bf16=2e-5+2**-8",
          against="plain_in_fp32")
    return errs[(FLASH_MAIN, "bfloat16")]


def ssm_args(torch, gen, B: int, S: int, di: int, N: int) -> tuple:
    """The catalog's input recipe: dt = softplus(normal), x, B, C normal,
    A = -(1..N) for every channel."""
    import torch.nn.functional as F
    dev = gen.device
    dt = F.softplus(torch.randn(B, S, di, generator=gen, device=dev))
    x = torch.randn(B, S, di, generator=gen, device=dev)
    Bc = torch.randn(B, S, N, generator=gen, device=dev)
    Cc = torch.randn(B, S, N, generator=gen, device=dev)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=dev).expand(di, N).contiguous())
    return dt, x, Bc, Cc, A_log


def check_ssm(torch) -> float:
    """The scan kernel against the plain version (both fp32) within the
    reference's 1e-4 (atol and rtol).  Returns the error at SSM_MAIN."""
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = []
    for shape in SSM_SHAPES + [SSM_MAIN]:
        args = ssm_args(torch, gen, *shape)
        out = ss.ssm_scan_cuda(*args)
        torch.cuda.synchronize()
        errs.append(compare(torch, out, ss.ssm_scan_plain(*args), SSM_TOL,
                            SSM_TOL))
        del args, out
    torch.cuda.empty_cache()
    phase("3/8 kernels", kernel="ssm_scan", cases=len(errs),
          max_abs_err_sweep=f"{max(errs[:-1]):.3e}",
          max_abs_err_jamba_S4096_di16384_N16=f"{errs[-1]:.3e}",
          tol="atol:1e-4,rtol:1e-4", against="plain_fp32")
    return errs[-1]


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
    phase("4/8 parity", config="mistral-nemo-12b/SMOKE/fp32",
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
    phase("5/8 serve.run", base_ms=res["base_ms"], p50_ms=res["p50_ms"],
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
    phase("5/8 serve.engine", requests=len(reqs), decode_steps=eng.steps,
          new_tokens=new, tokens_per_s=f"{new / wall:.1f}",
          wall_s=f"{wall:.2f}", launches=eng_launches,
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"decode_attention": run_launches + eng_launches}


# card vs CPU checksum limits: the kernel workloads sum fp32 outputs (each
# within 2e-5 or 1e-4 of the plain version), the train step sums bf16 losses
CHECKSUM_TOL = {"flash-prefill": (1e-3, 1e-4), "decode-serve": (1e-3, 1e-4),
                "ssm-scan": (1e-3, 1e-4), "lm-train-step": (0.0, 2e-2)}


def phase_profile(torch) -> dict:
    """MuxFlow's measurement loop on the card.  Returns the kernels' launch
    counts of this path."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.profiling import calibrate
    from repro_torch.profiling.harness import build_speed_matrix
    from repro_torch.profiling.matrix import check_schema
    t = time.perf_counter()
    cpu = build_speed_matrix("smoke", seed=0, device="cpu")
    cpu_s = time.perf_counter() - t

    da.launches = fa.launches = ss.launches = 0
    t = time.perf_counter()
    card = build_speed_matrix("smoke", seed=0)     # the card by default
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {"decode_attention": da.launches, "flash_attention": fa.launches,
              "ssm_scan": ss.launches}
    require(all(n > 0 for n in counts.values()),
            f"a kernel never launched on the profile path: {counts}")
    problems = check_schema(card.data)
    require(not problems, f"card matrix schema: {problems}")
    got, want = json.loads(card.to_json()), json.loads(cpu.to_json())
    for name, rec in card.records.items():
        g = got["workloads"][name].pop("checksum")
        w = want["workloads"][name].pop("checksum")
        atol, rtol = CHECKSUM_TOL[name]
        require(abs(g - w) <= atol + rtol * abs(w),
                f"{name}: checksum {g} on the card, {w} on the CPU")
        phase("6/8 profile.exec", workload=name, device="cuda",
              steps=rec.steps_executed,
              wall_ms_per_step=rec.wall_ms_per_step, checksum_card=g,
              checksum_cpu=w, tol=f"atol:{atol},rtol:{rtol}")
    require(got == want, "the card's matrix differs from the CPU-built one "
            "in a field other than the checksums")
    phase("6/8 profile", suite="smoke", seed=0, pairs=len(card.pairs),
          cells=sum(len(p["shares"]) for p in card.pairs), schema="clean",
          matrix="equal_to_cpu_but_checksums", launches=counts,
          wall_s=f"{wall:.2f}", cpu_matrix_s=f"{cpu_s:.2f}")

    t = time.perf_counter()
    pred = calibrate.build_measured_predictor(card)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    hist = pred.histories
    maes = {gpu: h["val_mae"][-1] for gpu, h in hist.items()}
    require(all(math.isfinite(m) and 0.0 <= m < 1.0 for m in maes.values()),
            f"bad validation MAE {maes}")
    require(all(p[0]["w"].device.type == "cuda"
                for p in pred.params_by_type.values()), "predictor not on card")
    phase("6/8 profile.predictor", device="cuda",
          epochs=len(hist["T4"]["val_mae"]),
          **{f"final_val_mae_{gpu}": m for gpu, m in maes.items()},
          seconds=f"{secs:.2f}")
    return counts


def phase_train(torch) -> None:
    """xlstm-350m FULL, bf16, through the port's train step (autograd,
    momentum SGD; no kernel of this repository)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import MomentumSGD, MomentumSGDConfig
    cfg = get_config("xlstm-350m", smoke=False)
    require(cfg.num_layers == 24 and cfg.d_model == 1024
            and cfg.dtype == torch.bfloat16, "not xlstm-350m FULL in bf16")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = MomentumSGD(MomentumSGDConfig(lr=1e-3, momentum=0.9))
    state = opt.init(list(params.parameters()))
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 512, 2, seed=0))
    losses, ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, metrics = step(params, state, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    phase("7/8 train", config="xlstm-350m/FULL/bf16", batch=2, seq=512,
          params=cfg.param_count(), losses=losses, step_ms=ms,
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()


def phase_timing(torch, launches: dict, max_err: dict) -> list:
    return [time_decode(torch, launches, max_err["decode_attention"]),
            time_flash(torch, launches, max_err["flash_attention"]),
            time_ssm(torch, launches, max_err["ssm_scan"])]


def time_decode(torch, launches: dict, max_err: float) -> dict:
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
    bound_ms, by = bound(nbytes, {"bf16": (flops, PEAK_FLOPS["bfloat16"])})
    phase("8/8 timing", kernel="decode_attention",
          shape=f"B{B}_Skv{Skv}_H{H}_Hk{Hk}_d{d}_bf16_kvlen{kv_len}",
          ms=ms, plain_ms=plain_ms, library_ms=library_ms,
          library_max_abs_err=f"{library_err:.3e}", bound_ms=bound_ms,
          bound_by=by)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:63",
            "launches": launches["decode_attention"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


def time_flash(torch, launches: dict, max_err: float) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hk, d, causal, window = FLASH_MAIN
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    dtype = torch.bfloat16
    q = torch.randn(B, Sq, H, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Skv, Hk, d, generator=gen, device=dev).to(dtype)
    saved = fa.launches
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                        causal=causal))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=causal), iters=3, warmup=1)
    fa.launches = saved                  # launches to time do not count
    # yardstick only, never called by the port: one SDPA call, causal, GQA
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    library_err = float((sdpa().transpose(1, 2).float() - fa.flash_attention_cuda(
        q, k, v, causal=causal).float()).abs().max())
    fa.launches = saved
    library_ms = time_ms(torch, sdpa)
    # the pairs the causal mask leaves: query row i sees keys 0..i
    visible = sum(min(i + 1, Skv) for i in range(Sq))
    flops = 4 * B * H * visible * d
    nbytes = (2 * B * Sq * H * d + 2 * B * Skv * Hk * d) * q.element_size()
    bound_ms, by = bound(nbytes, {"bf16": (flops, PEAK_FLOPS["bfloat16"])})
    phase("8/8 timing", kernel="flash_attention",
          shape=f"B{B}_S{Sq}_H{H}_Hk{Hk}_d{d}_bf16_causal", ms=ms,
          plain_ms=plain_ms, library_ms=library_ms,
          library_vs_kernel_max_abs_diff=f"{library_err:.3e}",
          bound_ms=bound_ms, bound_by=by, flops=flops, bytes=nbytes)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:71",
            "launches": launches["flash_attention"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


def time_ssm(torch, launches: dict, max_err: float) -> dict:
    from repro_torch.kernels import ssm_scan as ss
    B, S, di, N = SSM_MAIN
    args = ssm_args(torch, torch.Generator(device="cuda").manual_seed(5),
                    B, S, di, N)
    saved = ss.launches
    ms = time_ms(torch, lambda: ss.ssm_scan_cuda(*args))
    plain_ms = time_ms(torch, lambda: ss.ssm_scan_plain(*args), iters=2,
                       warmup=1)
    ss.launches = saved
    # dt, x read and y written once; B, C, A_log read once
    nbytes = (3 * B * S * di + 2 * B * S * N + di * N) * 4
    exps = B * S * di * N + di * N
    flops = 6 * B * S * di * N     # dt*A, dA*h + bx*B, h*C, the sum over N
    bound_ms, by = bound(nbytes, {"exp": (exps, PEAK_EXP_S),
                                  "fp32": (flops, PEAK_FLOPS["float32"])})
    phase("8/8 timing", kernel="ssm_scan",
          shape=f"B{B}_S{S}_di{di}_N{N}_fp32", ms=ms, plain_ms=plain_ms,
          library_ms=None, bound_ms=bound_ms, bound_by=by,
          bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
          exp_ms=exps / PEAK_EXP_S * 1e3,
          fp32_ms=flops / PEAK_FLOPS["float32"] * 1e3)
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:56",
            "launches": launches["ssm_scan"], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


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
    serve = phase_serve(torch)
    launches = phase_profile(torch)
    launches["decode_attention"] += serve["decode_attention"]
    missing = [name for name, n in launches.items() if n == 0]
    require(not missing, f"kernels never launched on the main path: {missing}")
    phase_train(torch)
    kernels = phase_timing(torch, launches, max_err)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
