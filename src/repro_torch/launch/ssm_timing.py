"""Time `ssm_scan` at jamba-1.5-large's Mamba width in several checkouts,
in turns, on one card.

  PYTHONPATH=src python -m repro_torch.launch.ssm_timing --roots OLD . . OLD

Each root is a checkout of this repository (a `git archive` of an older
commit unpacked under `build/`, or `.`); for each, in the order given, a
fresh process imports that checkout's `repro_torch`, builds its kernel and
times `kernels.ssm_scan.ssm_scan_cuda` at B1 S4096 di16384 N16 fp32 on the
catalog's inputs: CUDA events around 20 calls after 3 warm-up calls
(`ms`), device time in a CUDA graph of 20 calls replayed 10 times
(`graph_ms`), and the SM clock `nvidia-smi` reads right after the timed
loop.  Only the wrapper's public signature is used, so older checkouts time
the same way.  Prints one JSON line per run, with the card's name and power
limit.  Runs on the CUDA card only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, subprocess, sys
import torch
import torch.nn.functional as F
from repro_torch.kernels import ssm_scan as ss

B, S, di, N = 1, 4096, 16384, 16
gen = torch.Generator(device="cuda").manual_seed(5)
dt = F.softplus(torch.randn(B, S, di, generator=gen, device="cuda"))
x = torch.randn(B, S, di, generator=gen, device="cuda")
Bc = torch.randn(B, S, N, generator=gen, device="cuda")
Cc = torch.randn(B, S, N, generator=gen, device="cuda")
A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                               device="cuda").expand(di, N).contiguous())
call = lambda: ss.ssm_scan_cuda(dt, x, Bc, Cc, A_log)


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


for _ in range(3):
    call()
torch.cuda.synchronize()
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
start.record()
for _ in range(20):
    call()
end.record()
end.synchronize()
ms = start.elapsed_time(end) / 20
clocks = smi("clocks.sm,clocks.max.sm")
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    call()
torch.cuda.current_stream().wait_stream(side)
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph):
    for _ in range(20):
        call()
graph.replay()
torch.cuda.synchronize()
start.record()
for _ in range(10):
    graph.replay()
end.record()
end.synchronize()
print(json.dumps({"ms": ms, "graph_ms": start.elapsed_time(end) / 200,
                  "sm_clock_after_timed_loop": clocks,
                  "card": smi("name,power.limit")}))
"""


def time_root(root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(root),
                                                   "src"))
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"timing in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts to time, in this order")
    args = ap.parse_args(argv)
    for i, root in enumerate(args.roots):
        rec = {"turn": i, "root": root, "shape": "B1_S4096_di16384_N16_fp32",
               **time_root(root)}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
