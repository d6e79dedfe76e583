"""Render the dry-run's JSON records (build/dryrun/) into the §Dry-run and
§Roofline tables, as `repro/launch/report.py` renders its own.

  PYTHONPATH=src python -m repro_torch.launch.report > roofline.md

The columns, their order and the improvement hints are `repro`'s; the
`compile_s` column holds the seconds the port's trace took, and the HLO
GFLOPs column the traced ops' dot GFLOPs (`launch.trace_analysis`).  The
terms are H100 SXM datasheet-peak estimates, not measurements.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch import dryrun

OUT_DIR = dryrun.OUT_DIR
HARDWARE = (f"H100 SXM datasheet peaks: {dryrun.PEAK_FLOPS / 1e12:.0f} "
            f"TFLOP/s bf16, {dryrun.HBM_BW / 1e12:.2f} TB/s HBM3, "
            f"{dryrun.LINK_BW / 1e9:.0f} GB/s/link")


def load(mesh: str, out_dir: str | None = None) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir or OUT_DIR,
                                           f"*__{mesh}.json"))):
        if mesh == "16x16" and "2x16x16" in os.path.basename(f):
            continue
        with open(f) as fh:
            recs.append(json.load(fh))
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    recs.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9)))
    return recs


def _improvement_hint(r: dict) -> str:
    dom = r["dominant"]
    shape = r["shape"]
    if dom == "collective":
        if "moe" in r["arch"] or "deepseek" in r["arch"] or "jamba" in r["arch"]:
            return ("replace GSPMD partial-sum MoE combine with shard_map "
                    "all-to-all EP dispatch")
        return "reduce-scatter gradients / overlap FSDP gathers with compute"
    if dom == "memory":
        if shape == "train_4k":
            return ("cut fp32 score/loss traffic: chunked attention + fused "
                    "cross-entropy; tune remat policy")
        if shape in ("decode_32k", "long_500k"):
            return ("eliminate per-step cache copies and fp32 cache converts; "
                    "fuse decode attention (flash-decode kernel)")
        return "stream KV chunks (flash) to cut score materialization traffic"
    return "increase arithmetic intensity (larger per-device batch/tiles)"


def dryrun_section(mesh: str, out_dir: str | None = None) -> str:
    recs = load(mesh, out_dir)
    lines = [
        f"### Mesh {mesh} ({'512 chips, 2 pods' if mesh == '2x16x16' else '256 chips, 1 pod'})",
        "",
        "| arch | shape | status | compile_s | peak GiB/dev | HLO GFLOPs/dev | HBM GB/dev | link GB/dev | collectives |",
        "|---|---|---|---:|---:|---:|---:|---:|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']} | | | | | | "
                         f"{r.get('reason', r.get('error', ''))[:60]} |")
            continue
        h = r["trace"]
        br = ", ".join(f"{k}:{v/1e9:.1f}GB" for k, v in
                       sorted(h["collective_breakdown"].items(),
                              key=lambda kv: -kv[1])[:3])
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['trace_s']:.0f} "
            f"| {r['memory']['peak_device_bytes']/2**30:.1f} "
            f"| {h['dot_flops']/1e9:.0f} | {h['bytes']/1e9:.0f} "
            f"| {h['collective_bytes']/1e9:.1f} | {br} |")
    return "\n".join(lines)


def roofline_section(out_dir: str | None = None) -> str:
    recs = load("16x16", out_dir)
    lines = [
        f"Terms per device-step ({HARDWARE}; ring-model collective factors):",
        "",
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL_FLOPS/dev | useful (MF/HLO) | roofline frac | what would move the dominant term |",
        "|---|---|---:|---:|---:|---|---:|---:|---:|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            continue
        t = r["terms"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.4f} "
            f"| {t['memory_s']:.4f} | {t['collective_s']:.4f} | {r['dominant']} "
            f"| {r['model_flops']:.3g} | {r['useful_ratio']:.3f} "
            f"| {r['roofline_fraction']:.4f} | {_improvement_hint(r)} |")
    return "\n".join(lines)


def main() -> None:
    print("## §Dry-run\n")
    print(dryrun_section("16x16"))
    print()
    print(dryrun_section("2x16x16"))
    print("\n## §Roofline\n")
    print(roofline_section())


if __name__ == "__main__":
    main()
