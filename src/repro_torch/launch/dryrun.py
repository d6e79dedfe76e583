"""Multi-pod dry-run: trace every (arch x shape) on the production meshes
as one of their devices would run it, and record memory, per-device
traffic and the roofline terms.  Port of `repro/launch/dryrun.py`.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
Records go to build/dryrun/*.json (--force to redo a cached cell);
`python -m repro_torch.launch.report` renders them.

`repro` lowered and compiled each step for 512 placeholder devices and read
XLA's HLO.  The port runs the step eagerly, once, as rank 0 of a `fake`
process group of 256 or 512 ranks (collectives return at once), on
DTensors whose shards live on the meta device: shapes and types, no
memory and no arithmetic.  The kernels take their fake implementations,
the same function the card's route calls.  `launch.trace_analysis` counts
what rank 0 executes.  The fake CUDA tensors of `FakeTensorMode` cannot
serve here: on a CPU-only build the copies of every decode step raise for
want of a CUDA device guard, and host values the step reads (positions,
lengths) would become unreadable (ROADMAP.md F15).

A train cell with gradient accumulation traces one microbatch's forward
and backward and counts it `microbatches` times (the parts are alike),
then the optimizer step once; its peak memory is one microbatch's plus the
fp32 accumulators.  The Mamba scan's plain loop under autograd (S steps
of the same ops) is traced for `SCAN_STEPS` steps, forward and backward,
and counted S / SCAN_STEPS times (`_SampledScan`): the meta device's
Python shape functions take about half a millisecond an op, and jamba's
train step runs some 10**7 of them in the loop (F15).

The hardware model is the H100 SXM's datasheet peaks, not measurements:
dense BF16 989 TFLOP/s, HBM3 3.35 TB/s, and NVLink 4's 900 GB/s per GPU,
450 GB/s each way, as the ring's link bandwidth (within a node; a 256-GPU
mesh also crosses nodes, whose links are slower).  `repro` modelled TPU
v5e (197 TFLOP/s, 819 GB/s, 50 GB/s a link; ROADMAP.md F9).  A fake
process group and a real one cannot share a process: the dry-run owns its
process and destroys its group on exit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES, batch_specs, decode_specs,
                                 get_config, supports_shape)
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.launch.trace_analysis import TraceStats, local_bytes, trace
from repro_torch.models import make_decode_step, make_prefill
from repro_torch.models.model import Transformer
from repro_torch.models.steps import loss_fn
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.sharding import (activation_mesh, batch_sharding,
                                  cache_sharding, opt_state_sharding,
                                  param_sharding)
from repro_torch.sharding.rules import distribute_params, distribute_tree

# H100 SXM datasheet peaks (per GPU): dense BF16 tensor-core FLOP/s, HBM3
# bytes/s, and NVLink 4's 900 GB/s total as 450 GB/s each way
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")
DEVICE = "meta"

# Gradient-accumulation factors for cells whose activations exceed HBM at
# full global batch (production practice for very large models).
TRAIN_MICROBATCHES = {
    "jamba-1.5-large-398b": 16,
}

# Beyond-paper optimized variant (§Perf): per-arch config overrides applied
# with --variant opt.  The baseline records stay untouched.
OPT_OVERRIDES = {
    "deepseek-v2-lite-16b": {"moe_impl": "a2a"},
    "granite-moe-1b-a400m": {"moe_impl": "a2a"},
    "jamba-1.5-large-398b": {"moe_impl": "a2a"},
}

# §Perf: the opt variant amortizes FSDP gathers / grad reduce-scatters over
# fewer, larger microbatches (jamba iteration 3: 16 -> 8).
OPT_MICROBATCHES = {
    "jamba-1.5-large-398b": 8,
}


def model_flops_per_device(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_devices
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch / n_devices


SCAN_STEPS = 2


class _SampledScan(torch.autograd.Function):
    """`ref.ssm_scan_reference` in a dry-run trace: its loop run for
    SCAN_STEPS steps, forward and backward, and counted S / SCAN_STEPS
    times; outputs of the full shapes (meta tensors)."""

    @staticmethod
    def forward(ctx, dt, x, B_ssm, C_ssm, A_log, h0):
        from repro_torch.launch.trace_analysis import active, repeat_counts
        ctx.save_for_backward(dt, x, B_ssm, C_ssm, A_log, h0)
        k = min(SCAN_STEPS, x.shape[1])
        repeat_counts(active(), lambda: _REFERENCE[0](
            *(t[:, :k] for t in (dt, x, B_ssm, C_ssm)), A_log, h0,
            True), x.shape[1] / k)
        Bsz, S, di = x.shape
        return (x.new_empty((Bsz, S, di), dtype=torch.float32),
                x.new_empty((Bsz, di, B_ssm.shape[2]), dtype=torch.float32))

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.launch.trace_analysis import active, repeat_counts
        dt, x, B_ssm, C_ssm, A_log, h0 = ctx.saved_tensors
        k = min(SCAN_STEPS, x.shape[1])
        ins = [t[:, :k].detach().requires_grad_(True)
               for t in (dt, x, B_ssm, C_ssm)]
        a = A_log.detach().requires_grad_(True)

        def step():
            with torch.enable_grad():
                y, h = _REFERENCE[0](*ins, a, h0, True)
                return torch.autograd.grad((y, h), ins + [a],
                                           (gy[:, :k], gh))
        repeat_counts(active(), step, x.shape[1] / k)
        return (torch.zeros_like(dt), torch.zeros_like(x),
                torch.zeros_like(B_ssm), torch.zeros_like(C_ssm),
                torch.zeros_like(A_log), None)


_REFERENCE: list = []


def _sampled_scan(dt, x, B_ssm, C_ssm, A_log, h0=None,
                  return_state: bool = False):
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], x.shape[2], B_ssm.shape[2]),
                         dtype=torch.float32)
    y, h = _SampledScan.apply(dt, x, B_ssm, C_ssm, A_log, h0)
    return (y, h) if return_state else y


class sampled_scan:
    """Within: the plain scan is `_SampledScan`."""

    def __enter__(self):
        from repro_torch.kernels import ref
        _REFERENCE.append(ref.ssm_scan_reference)
        ref.ssm_scan_reference = _sampled_scan

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        ref.ssm_scan_reference = _REFERENCE.pop()


def fake_group(world: int) -> None:
    """A `fake` process group of `world` ranks, this process rank 0 (an
    existing fake group of another size is replaced; a real one raises)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs its own process: a real "
                               "process group is initialised here")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _meta(specs: dict) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=DEVICE)
            for k, s in specs.items()}


def build_cell(cfg, shape, mesh, *, serve_mode: str | None = None,
               microbatches: dict | None = None):
    """(fn, args, repeats): fn(*args) runs the cell's step as rank 0 on
    `mesh`; `repeats` lists (traced part, times it runs) when the step is
    traced in parts (a train step with microbatches)."""
    model = Transformer(cfg, DEVICE)
    if serve_mode is None:
        # big models cannot replicate across the data axis in serving:
        # TP-only leaves param_bytes/TP per device; above ~6 GiB switch to
        # 2D (FSDP x TP) weight sharding (weight-gathered serving).
        pbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        serve_mode = ("serve_big" if pbytes / axis_sizes(mesh)["model"]
                      > 6 * 2**30 else "serve")
    p_mode = "train" if shape.kind == "train" else serve_mode
    p_specs = param_sharding(mesh, model, mode=p_mode)
    distribute_params(model, mesh, p_specs, src_data_rank=None)

    if shape.kind == "train":
        opt = AdamW(AdamWConfig(master_weights=False))
        mb = (microbatches or TRAIN_MICROBATCHES).get(cfg.name, 1)
        weights = list(model.parameters())
        state = opt.init(weights)
        state = distribute_tree(state, mesh, opt_state_sharding(
            mesh, p_specs, state), src_data_rank=None)
        part = dataclasses.replace(shape,
                                   global_batch=shape.global_batch // mb)
        batch = _meta(batch_specs(cfg, part))
        batch = distribute_tree(batch, mesh, batch_sharding(mesh, batch),
                                src_data_rank=None)

        def grads():
            for w in weights:
                w.requires_grad_(True)
            with torch.enable_grad():
                loss, _ = loss_fn(model, cfg, batch)
                g = torch.autograd.grad(loss, weights)
            for w in weights:
                w.requires_grad_(False)
            return loss, g

        def update(g):
            return opt.update(weights, g, state)

        acc = sum(p.numel() * 4 for p in (w.to_local() for w in weights)) \
            if mb > 1 else 0
        return (grads, update, acc), (model, state, batch), mb

    if shape.kind == "prefill":
        batch = _meta(batch_specs(cfg, shape))
        batch = distribute_tree(batch, mesh, batch_sharding(mesh, batch),
                                src_data_rank=None)
        prefill = make_prefill(cfg)
        return (lambda: prefill(model, batch)), (model, batch), 1

    specs = decode_specs(cfg, shape)
    cache = distribute_tree(specs["cache"], mesh, cache_sharding(
        mesh, specs["cache"]), src_data_rank=None)
    tokens = torch.zeros(specs["tokens"].shape, dtype=specs["tokens"].dtype,
                         device=DEVICE)
    decode = make_decode_step(cfg)
    return ((lambda: decode(model, cache, tokens, specs["pos"])),
            (model, cache, tokens), 1)


def _run(fn, args, mb) -> tuple[TraceStats, dict]:
    """Trace the cell's step: (stats, memory)."""
    arg_bytes = local_bytes([list(a.parameters()) if hasattr(a, "parameters")
                             else a for a in args])
    if not isinstance(fn, tuple):
        out, st = trace(fn)
        out_b = local_bytes(out)
        alias = local_bytes(args[1]) if isinstance(args[1], tuple) else 0
        return st, {"argument_bytes": arg_bytes, "output_bytes": out_b,
                    "temp_bytes": st.peak_temp_bytes, "alias_bytes": alias}
    grads, update, acc = fn
    (_, g), st_fb = trace(grads)
    _, st_up = trace(update, g)
    st = st_fb.scaled(mb).plus(st_up)
    temp = max(st_fb.peak_temp_bytes + acc, st_up.peak_temp_bytes + acc)
    st.peak_temp_bytes = temp
    return st, {"argument_bytes": arg_bytes, "output_bytes": 0,
                "temp_bytes": temp, "alias_bytes": 0}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             variant: str = "base", overrides=None) -> dict:
    cfg = get_config(arch)
    if variant == "opt":
        cfg = get_config(arch, **OPT_OVERRIDES.get(arch, {}))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, reason = supports_shape(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    n_dev = 512 if multi_pod else 256
    t0 = time.time()
    try:
        fake_group(n_dev)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
        mbs = dict(TRAIN_MICROBATCHES)
        if variant == "opt":
            mbs.update(OPT_MICROBATCHES)
        with activation_mesh(mesh), sampled_scan():
            fn, args, mb = build_cell(cfg, shape, mesh, microbatches=mbs)
            t_build = time.time() - t0
            st, mem = _run(fn, args, mb)
        t_trace = time.time() - t0 - t_build
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug to record
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return rec
    mem["peak_device_bytes"] = (mem["argument_bytes"] + mem["temp_bytes"]
                                + mem["output_bytes"] - mem["alias_bytes"]
                                if mem["output_bytes"] else
                                mem["argument_bytes"] + mem["temp_bytes"])
    mf = model_flops_per_device(cfg, shape, n_dev)
    compute_s = st.flops / PEAK_FLOPS
    memory_s = st.bytes_accessed / HBM_BW
    collective_s = st.collective_bytes / LINK_BW
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    bound = max(compute_s, memory_s, collective_s)
    # decode is bandwidth-bound by nature: its roofline fraction is measured
    # against the *minimal* per-step HBM traffic (params + cache read once)
    model_bytes = None
    if shape.kind == "decode":
        model, cache = args[0], args[1]
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in cache for t in c.values())
        pb = sum(p.numel() * p.element_size() for p in model.parameters())
        model_bytes = (cache_bytes + pb * (cfg.active_param_count()
                                           / max(cfg.param_count(), 1))) / n_dev
    rec.update(
        status="ok",
        build_s=round(t_build, 2), trace_s=round(t_trace, 2),
        microbatches=mb,
        memory=mem,
        trace={"dot_flops": st.flops, "elementwise_flops": st.elementwise_flops,
               "bytes": st.bytes_accessed,
               "collective_bytes": st.collective_bytes,
               "collective_count": st.collective_count,
               "collective_breakdown": st.collective_breakdown,
               "collective_largest": st.collective_largest, "ops": st.ops},
        terms={"compute_s": compute_s, "memory_s": memory_s,
               "collective_s": collective_s},
        dominant=dominant,
        model_flops=mf,
        useful_ratio=(mf / st.flops if st.flops else 0.0),
        roofline_fraction=(((model_bytes / HBM_BW) / bound)
                           if (model_bytes and bound) else
                           ((mf / PEAK_FLOPS) / bound if bound else 0.0)),
        model_bytes=model_bytes,
    )
    return rec


def cell_path(arch, shape_name, multi_pod, variant="base"):
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = "" if variant == "base" else f"__{variant}"
    return os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh}{suffix}.json")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    args = ap.parse_args(argv)
    os.makedirs(OUT_DIR, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    try:
        for arch, shape_name in cells:
            path = cell_path(arch, shape_name, args.multi_pod, args.variant)
            if os.path.exists(path) and not args.force:
                print(f"[skip cached] {arch} × {shape_name}")
                continue
            print(f"=== {arch} × {shape_name} "
                  f"({'multi' if args.multi_pod else 'single'}-pod, "
                  f"{args.variant}) ===", flush=True)
            rec = run_cell(arch, shape_name, multi_pod=args.multi_pod,
                           variant=args.variant)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                t = rec["terms"]
                print(f"  ok: trace={rec['trace_s']}s peak_mem="
                      f"{rec['memory']['peak_device_bytes']/2**30:.2f}GiB "
                      f"terms(c/m/coll)={t['compute_s']:.4f}/"
                      f"{t['memory_s']:.4f}/{t['collective_s']:.4f}s "
                      f"dominant={rec['dominant']} "
                      f"roofline={rec['roofline_fraction']:.3f}", flush=True)
            else:
                print(f"  {rec['status']}: "
                      f"{rec.get('reason') or rec.get('error')}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
