"""The control of the check: the reference put in the program's place and
computed one precision below the configuration's (fp8 e4m3 for a bf16
model), on a cell's own inputs and sizes.  Its readings must come out over
the limits; they set each limit's upper end.

  python3 muxbench/control.py --workload NAME --seeds N [N ...] [--steps S]

Every projection's two operands are rounded to fp8 e4m3 (the activations
scaled per row, the weights per output column, each to its largest
magnitude; gradients pass straight through), the rest stays fp32.  For
the online side it reads, at each position of the seed's prompts and fed
tokens, the gap of the token the fp8 model puts first under the fp32
reference, the widest over as many (step, row) pairs as a run's requests
(drawn from the seed), and the logits' relative distance at the run's
sampled steps; for the offline side, the set-up steps' gaps against the
fp32 reference's, and the window step's numbers at the state the fp32
reference's set-up steps leave (the reference cannot afford the window's
tens of steps to reach the state of the step a run checks), with AdamW's
change computed in bf16, the precision below its fp32.  Prints one JSON line a seed.  The benchmark's own runs
never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
E4M3_MAX = 448.0


def q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to fp8 e4m3, scaled along `dim` to its largest magnitude;
    the gradient passes through unchanged."""
    s = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) \
        / E4M3_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t.detach())


def mm8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return q8(a, -1) @ q8(b, -2)


def readings(parts: dict, seed: int, dev, steps: int | None = None,
             seconds: float = 30.0) -> dict:
    from muxbench import bench, weights
    config, mix = parts["config"], parts["mix"]
    m = dict(config["model"])
    served = getattr(torch, config["dtype"])
    ref = bench.load_module(parts["reference"])
    leaves = ref.leaves(m)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def fresh():
        return {n: t.float() for n, t in
                weights.draw(leaves, seed, dev, served).items()}
    out = {"seed": seed}
    out.update(online_readings(parts, seed, dev, steps, seconds, ref, m,
                               served, fresh))
    if mix.get("offline"):
        out.update(offline_readings(parts, seed, dev, ref, m, served, fresh))
    return out


def offline_readings(parts, seed, dev, ref, m, served, fresh) -> dict:
    """The offline side's numbers of the fp8 control (AdamW's change in
    bf16) against the fp32 reference, from the seed's weights."""
    from muxbench import bench, weights
    off, V, out = parts["mix"]["offline"], m["vocab_size"], {}
    drv = bench.load_module(parts["sides"]["offline"])
    names = [name for name, *_ in ref.leaves(m)]
    n = off["checked_steps"]
    batches = weights.tokens(seed, "batches", (off["batches"], off["batch"],
                                               off["seq"]), V, dev)
    r32 = drv.reference_steps(ref, fresh(), m, names, batches[:n],
                              off["adamw"], served, keep=True)
    st = r32.pop("state")
    r8 = drv.reference_steps(ref, fresh(), m, names, batches[:n],
                             off["adamw"], served, mm=mm8)
    out.update(drv.gaps(r8, r32))
    del r8, r32
    # the window step's numbers at the state the set-up steps leave,
    # on the next batch: the loss through fp8 products, AdamW's change
    # in bf16
    args = (ref, st["w"], st["m"], st["v"], st["step"], m, names,
            batches[n], off["adamw"], served)
    out.update(drv.window_gaps(
        drv.window_reference(*args, mm=mm8, dtype=torch.bfloat16),
        drv.window_reference(*args)))
    return out


def online_readings(parts, seed, dev, steps, seconds, ref, m, served,
                    fresh) -> dict:
    from muxbench import arrivals, bench, weights
    mix = parts["mix"]
    on = mix["online"]
    drv = bench.load_module(parts["sides"]["online"])
    B, P, V = on["sessions"], on["prompt_len"], m["vocab_size"]
    room = on["cache_rows"] - P
    n_req = len(arrivals.arrival_times(mix["arrivals"], seed, seconds))
    n = steps or n_req + on["warmup_steps"] + on["base_steps"]
    prompts = weights.tokens(seed, "prompts", (B, P), V, dev)
    fed = weights.tokens(seed, "tokens", (room, B), V, dev)[:n]
    pick = torch.rand(room, generator=weights.generator(
        seed, "sample", "cpu")) < on["sample_share"]
    kept = [-1, n - 1] + [i for i in torch.nonzero(pick)[:, 0].tolist()
                          if i < n]
    g = torch.Generator().manual_seed(weights.sub_seed(seed, "sample"))
    pairs = torch.randint(0, n * B, (n_req,), generator=g)
    w = fresh()
    gaps, rels = [], []
    with torch.no_grad():
        for b in range(B):
            L32 = drv.row_logits(ref, w, m, prompts[b], fed[:, b], served, dev)
            L8 = drv.row_logits(ref, w, m, prompts[b], fed[:, b], served, dev,
                                mm=mm8)
            at = pairs[pairs % B == b] // B + 1
            if at.numel():
                gaps.append(drv.served_gaps(L32[at], L8[at].argmax(-1)))
            rels += [drv.logits_rel(L8[s + 1], L32[s + 1]) for s in kept]
            del L32, L8
    return {**drv.numbers(torch.cat(gaps), torch.tensor(rels)), "steps": n,
            "requests": n_req}


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from muxbench import bench
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    parts = bench.resolve(b, args.workload)
    dev = torch.device("cuda")
    for s in args.seeds:
        r = readings(parts, s, dev, args.steps,
                     args.seconds or b["run_seconds"])
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
