"""One run of one benchmark cell: set-up, the measured window, the check.

The cell (an entry of `workloads` in BENCHMARK.json) names a
configuration (`muxbench/configs/<config>.json`) and a traffic mix
(`muxbench/mixes/<traffic>.json`).  The configuration names its plain
reference (`muxbench/reference/<reference>.py`), which also gives a
step's work counts; the mix names the implementation of its online side
and of its offline side (`muxbench/sides/<impl>.py`), and each per-layer
metric is read by `muxbench/metrics/<metric>.py`: the harness finds every
piece by its name, so a new configuration, cell, mix, side or metric is a
new file and a new entry.  The check's limits are the configuration's,
with those a cell sets from its own readings
(`muxbench/limits/<cell>.json`) over them.

A traced run hands each reader `rd`: the loop's record (`rec`), the
device trace's summary (`trace`), the program's spans joined to it
(`spans`, `muxbench/spans.py`), and the program's counters as deltas
(`counters`: "before", from the window's start to the traced stretch's,
and "traced", from there to the close).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent


def load_module(path: Path):
    """A module from a file path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(
        "muxbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str, base: Path = HERE) -> dict:
    """The cell's entry, its configuration and mix, the end-to-end and
    per-layer metrics it reports, and the files each comes from."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[cell["config"]]
    config = json.loads((base.parent / conf_entry["file"]).read_text())
    mix = json.loads((base / "mixes" / f"{cell['traffic']}.json").read_text())

    def mine(metric):
        return workload in metric.get("workloads", [workload])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per_layer = [m for m in bench["per_layer"] if mine(m)]
    readers = {m["name"]: base / "metrics" / f"{m['name']}.py"
               for m in per_layer}
    sides = {side: base / "sides" / f"{mix[side]['impl']}.py"
             for side in ("online", "offline") if mix.get(side)}
    reference = base / "reference" / f"{config['reference']}.py"
    # a cell may set its own limit for a number, from its own readings
    limits = dict(config["limits"])
    own = base / "limits" / f"{workload}.json"
    if own.exists():
        limits.update(json.loads(own.read_text()))
    return {"cell": cell, "config": config, "mix": mix, "e2e": e2e,
            "per_layer": per_layer, "readers": readers, "sides": sides,
            "reference": reference, "limits": limits}


def port_config(config: dict):
    """The program's ModelConfig for the configuration file: the port's
    architecture with the file's sizes and settings."""
    import torch
    from repro_torch.configs import get_config
    fields = dict(config["model"])
    fields["dtype"] = getattr(torch, config["dtype"])
    return get_config(config["arch"], **fields)


def as_module(cfg, w: dict):
    """The program's model object holding the weights `w` (by name)."""
    import torch
    from repro_torch.models.model import Transformer
    model = Transformer(cfg, torch.device("meta"))
    names = {n: p for n, p in model.named_parameters()}
    if set(names) != set(w):
        raise RuntimeError("the program's weights differ from the "
                           f"reference's: {sorted(set(names) ^ set(w))[:6]}")
    for name, t in w.items():
        if tuple(names[name].shape) != tuple(t.shape) \
                or names[name].dtype != t.dtype:
            raise RuntimeError(f"{name}: the program holds "
                               f"{tuple(names[name].shape)} "
                               f"{names[name].dtype}, the reference "
                               f"{tuple(t.shape)} {t.dtype}")
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, torch.nn.Parameter(t, requires_grad=False))
    return model


def percentile(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q)) if len(x) else float("nan")


def run(parts: dict, *, seed: int, seconds: float, trace: bool,
        t_process: float, device=None, clock=None) -> dict:
    """Runs the cell once and returns the result line's object (and, under
    "_lines", the lines for standard error, under "_readings" every
    number the check read).  `device` and `clock` are for
    the harness's own tests on the CPU."""
    import torch

    from muxbench import arrivals as A, loop, spans as S, trace as T, \
        weights, work
    from repro_torch.core.multiplexer import Multiplexer, MuxConfig

    config, mix = parts["config"], parts["mix"]
    dev = torch.device(device or "cuda")
    cfg = port_config(config)
    ref = load_module(parts["reference"])
    model = dict(config["model"])
    served = cfg.dtype
    lines = []
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    clock = clock or loop.WallClock
    ctx = SimpleNamespace(device=dev, cfg=cfg, model=model, served=served,
                          dtype_name=str(served).split(".")[-1], seed=seed,
                          sync=sync, clock=clock.now, ref=ref)
    sides = {side: load_module(p).Side(ctx, mix[side])
               for side, p in parts["sides"].items()}
    online, offline = sides["online"], sides.get("offline")
    leaves = ref.leaves(model)

    w_online = weights.draw(leaves, seed, dev, served)
    online.setup(as_module(cfg, w_online))
    if offline is not None:
        offline.setup(as_module(cfg, weights.draw(leaves, seed, dev, served)),
                      w_online)
    online.measure_base()
    # the offline side's buffers for its checked window step are the
    # harness's, not the program's: the peak leaves them out
    held, peak0 = 0, 0
    if offline is not None:
        a0 = torch.cuda.memory_allocated(dev) if cuda else 0
        peak0 = torch.cuda.max_memory_allocated(dev) if cuda else 0
        offline.reserve()
        if cuda:
            held = torch.cuda.memory_allocated(dev) - a0
            torch.cuda.reset_peak_memory_stats(dev)
    tracer = T.Tracer(cuda) if trace else None
    if tracer:
        tracer.warm_up()

    times = A.arrival_times(mix["arrivals"], seed, seconds)
    if not online.room_for(len(times)):
        raise RuntimeError(f"{len(times)} requests would not fit the "
                           "decode cache: raise the mix's cache_rows")
    mux = Multiplexer(lambda b: 0.0, lambda: 0.0, online.base_s, 1.0,
                      MuxConfig(**mix["mux"]))
    works = {}
    traced_jobs = []        # the offline steps the traced stretch held

    def side_fn(side):
        def step(*a):
            i = side.step(*a)
            works[(side.kind, i)] = side.work(i)
            if tracer and tracer.active and side.kind == "offline":
                traced_jobs.append(i)
            return i
        return step

    trace_from = seconds - mix["trace_seconds"]
    counts = {}             # the counters at the window's start, the
                            # traced stretch's and the close

    def counters():
        c = {"granted": mux.throttle.granted, "refused": mux.throttle.refused}
        for d in sides.values():
            c.update(d.counters())
        return c

    def on_turn(t):
        if t is None:
            if offline is not None and tracer.active and not traced_jobs:
                # the throttle granted the job no step in the stretch (its
                # PID starves the job after a stall, PERF.md): the step
                # after the close is traced for the train step's readers,
                # and left out of the trace's summary
                tracer.end_stretch()
                offline.step_after_close()
            tracer.stop()
            return False
        if t >= trace_from and not tracer.active:
            counts["traced"] = counters()
            tracer.start()
        return tracer.active

    gc.collect()
    gc.freeze()             # set-up's objects are never scanned again
    sync()
    t_window = clock.now()
    setup_s = t_window - t_process
    if offline is not None:
        offline.arm(t_window, seconds)
    if tracer:
        counts["window"] = counters()
    rec = loop.run_window(
        times, seconds, side_fn(online),
        side_fn(offline) if offline else None, mux.throttle,
        max_batch=mux.cfg.max_batch, quantum=mux.cfg.quantum_s,
        base_s=online.base_s, slo_slowdown=mux.cfg.slo_slowdown,
        clock=clock, on_turn=on_turn if tracer else None)
    if tracer:
        counts["close"] = counters()
    gc.unfreeze()
    for s in rec.spans:
        s.work = works[(s.kind, s.step)]
    peak = max(peak0, int(torch.cuda.max_memory_allocated(dev)) - held) \
        if cuda else 0

    # the outputs go to the host and the program's state is freed before
    # the reference runs, so that the reference sets no peak of its own
    for d in sides.values():
        d.close()
    del w_online, mux
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = {}
    for d in sides.values():
        w = {n: t.float() for n, t in
             weights.draw(leaves, seed, dev, served).items()}
        numbers.update(d.check(rec, ref, w))
        del w
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in parts["limits"].items()}
    lat = rec.latency
    answered = ~np.isnan(lat)
    correct = bool(answered.all()) and all(
        c["value"] <= c["limit"] for c in checks.values())

    budget = loop.guard_budget_s(MuxConfig(**mix["mux"]), online.base_s)
    lat_ms = lat[answered] * 1e3
    tok = loop.offline_tokens(rec, offline.tokens_per_step) if offline else 0
    online_steps = [s for s in rec.spans if s.kind == "online"]
    lines.append(
        f"[run] requests={len(lat)} answered={int(answered.sum())} "
        f"online_steps={len(online_steps)} offline_steps="
        f"{sum(s.kind == 'offline' for s in rec.spans)} "
        f"base_ms={online.base_s * 1e3:.4f} p50_ms={percentile(lat_ms, 50)} "
        f"p95_ms={percentile(lat_ms, 95)} p99_ms={percentile(lat_ms, 99)} "
        f"online_rps={len(lat) / seconds} mean_ms_by_third="
        f"{thirds(rec.due[answered], lat_ms, seconds)} "
        f"guard_budget_ms={budget * 1e3:.4f} "
        f"over_guard={int((lat[answered] > budget).sum())} "
        f"offline_tokens={tok} setup_s={setup_s}")

    if trace:
        summary = tracer.summary(rec)
        lines.append(trace_line(rec, summary, len(traced_jobs)))
        joined = S.join(tracer.events, tracer.spans)
        lines.append(S.line(joined, tracer.dropped))
        cut = counts.get("traced", counts["close"])
        deltas = {"before": delta(counts["window"], cut),
                  "traced": delta(cut, counts["close"])}
        lines.append("[counters] " + " ".join(
            f"{part}.{k}={v}" for part, d in deltas.items()
            for k, v in d.items()))
        rd = SimpleNamespace(rec=rec, trace=summary, model=model,
                             peak_flops=work.PEAK_FLOPS[ctx.dtype_name],
                             spans=joined, counters=deltas)
        metrics = {}
        for m in parts["per_layer"]:
            v = load_module(parts["readers"][m["name"]]).read(rd)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"online_p95_ms": percentile(lat_ms, 95),
               "offline_tokens_per_s": tok / seconds, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in parts["e2e"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": int(len(lat)),
           "failed": int((~answered).sum()), "metrics": metrics,
           "device": device}
    if trace:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = summary["breakdown"]
    out["checks"] = checks
    out["_record"] = rec
    out["_readings"] = numbers
    lines.append("[readings] " + " ".join(f"{k}={v!r}"
                                          for k, v in numbers.items()))
    out["_lines"] = lines + [f"check {k} {c['value']!r} limit {c['limit']!r}"
                             for k, c in checks.items()]
    return out


def trace_line(rec, summary: dict, job_steps: int) -> str:
    """What the traced stretch held against the window before it: the
    offline steps' share of the wall time in each, the job's steps in the
    stretch (0: its step after the close was traced instead), and the
    device's busy seconds by the loop's step they fell in."""
    def share(lo, hi):
        return 100.0 * sum(max(0.0, min(s.end, hi) - max(s.start, lo))
                           for s in rec.spans if s.kind == "offline") \
            / max(hi - lo, 1e-9)
    cut = rec.trace_from if rec.trace_from is not None else rec.seconds
    return (f"[trace] offline_share_before_pct={share(0.0, cut)} "
            f"offline_share_traced_pct={share(cut, rec.seconds)} "
            f"job_steps_traced={job_steps} "
            f"busy_s={summary['busy_s']} window_s={summary['window_s']} "
            f"busy_by_step={summary['busy_by_step']}")


def delta(a: dict, b: dict) -> dict:
    """Each counter's growth from reading a to reading b."""
    return {k: b[k] - a[k] for k in a}


def thirds(due, lat_ms, seconds: float) -> str:
    """Mean latency of the requests due in each third of the window: a
    backlog that grows shows as a rise."""
    parts = [lat_ms[(due >= k * seconds / 3) & (due < (k + 1) * seconds / 3)]
             for k in range(3)]
    return "/".join(f"{p.mean():.2f}" if len(p) else "-" for p in parts)


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules the run may not hold."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({n.split(".")[0] for n in list(sys.modules)} & banned)
