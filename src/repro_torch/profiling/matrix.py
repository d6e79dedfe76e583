"""The speed-matrix artifact, copied from `repro/profiling/matrix.py`:
versioned, schema-checked, byte-reproducible.  The port writes the same
schema, so its artifacts and `repro`'s are interchangeable.

A speed matrix is what the profiling harness measured: for every
online×offline workload pair, the online slowdown and normalized offline
throughput across a sweep of assigned SM shares, plus each workload's
separate-execution profile and execution checksum.  The calibration layer
(:mod:`repro_torch.profiling.calibrate`) turns it into an interference
provider and a predictor training set.

Serialization is canonical: floats rounded to 9 places, keys sorted, no
wall-clock fields — two same-seed runs produce byte-identical files (CI
``cmp``s them).
"""
from __future__ import annotations

import dataclasses
import json

SCHEMA = "repro.profiling.speed_matrix/v1"

_WORKLOAD_KEYS = ("role", "flops_per_step", "bytes_per_step", "cost_ms",
                  "cost_quanta", "steps_executed", "checksum", "profile")
_PROFILE_KEYS = ("gpu_util", "sm_activity", "sm_occupancy", "mem_bw",
                 "exec_time_ms", "mem_bytes_frac")
_PAIR_KEYS = ("online", "offline", "shares", "online_slowdown",
              "offline_tput", "achieved_share", "online_p99_ms",
              "n_online", "n_offline", "monitor_healthy_frac")


def _rounded(obj, ndigits: int = 9):
    """Recursively round floats so serialization is canonical."""
    if isinstance(obj, float):
        return round(obj, ndigits)
    if isinstance(obj, dict):
        return {k: _rounded(v, ndigits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_rounded(v, ndigits) for v in obj]
    return obj


@dataclasses.dataclass
class SpeedMatrix:
    """In-memory form of the artifact; ``data`` is the schema-shaped dict.
    ``records`` holds the execution records of the run that built it (wall
    times included); it is never serialized, and a loaded matrix has none."""
    data: dict
    records: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    # ------------------------------------------------------------- assembly
    @classmethod
    def from_run(cls, suite, seed: int, profiler, records,
                 grid) -> "SpeedMatrix":
        """Assemble from a :class:`~repro_torch.profiling.harness.PairProfiler`
        run.  Wall-time stats in the execution records are deliberately
        kept out of ``data`` — only deterministic fields enter the
        artifact."""
        workloads = {}
        for name, rec in records.items():
            w = rec.workload
            p = rec.profile
            workloads[name] = {
                "role": w.role,
                "flops_per_step": float(w.flops_per_step),
                "bytes_per_step": float(w.bytes_per_step),
                "cost_ms": w.cost_s() * 1e3,
                "cost_quanta": profiler.cost_quanta(w),
                "steps_executed": rec.steps_executed,
                "checksum": rec.checksum,
                "profile": {k: float(getattr(p, k)) for k in _PROFILE_KEYS},
            }
        pairs = []
        for (on, off), cells in sorted(grid.items()):
            pairs.append({
                "online": on, "offline": off,
                "shares": [c.share for c in cells],
                "online_slowdown": [c.online_slowdown for c in cells],
                "offline_tput": [c.offline_tput for c in cells],
                "achieved_share": [c.achieved_share for c in cells],
                "online_p99_ms": [c.online_p99_ms for c in cells],
                "n_online": [c.n_online for c in cells],
                "n_offline": [c.n_offline for c in cells],
                "monitor_healthy_frac": [c.monitor_healthy_frac
                                         for c in cells],
            })
        return cls({
            "schema": SCHEMA,
            "suite": suite.name,
            "seed": seed,
            "cost_model": "roofline-v1",
            "quantum_ms": profiler.quantum_s() * 1e3,
            "horizon_quanta": suite.horizon_quanta,
            "telemetry_window": suite.telemetry_window,
            "workloads": workloads,
            "pairs": pairs,
        }, dict(records))

    # -------------------------------------------------------------- access
    @property
    def workloads(self) -> dict:
        return self.data["workloads"]

    @property
    def pairs(self) -> list[dict]:
        return self.data["pairs"]

    def pair(self, online: str, offline: str) -> dict:
        for p in self.pairs:
            if p["online"] == online and p["offline"] == offline:
                return p
        raise KeyError(f"no measured pair ({online!r}, {offline!r})")

    # ------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps(_rounded(self.data), indent=2, sort_keys=True) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "SpeedMatrix":
        with open(path) as f:
            data = json.load(f)
        problems = check_schema(data)
        if problems:
            raise ValueError(f"invalid speed matrix {path}: "
                             + "; ".join(problems))
        return cls(data)


def check_schema(data: dict) -> list[str]:
    """Validate the v1 artifact shape and value contracts; returns a list of
    problems (empty = valid)."""
    problems: list[str] = []
    if data.get("schema") != SCHEMA:
        problems.append(f"schema != {SCHEMA!r}: {data.get('schema')!r}")
    for key in ("suite", "seed", "cost_model", "quantum_ms",
                "horizon_quanta", "telemetry_window", "workloads", "pairs"):
        if key not in data:
            problems.append(f"missing key {key!r}")
    workloads = data.get("workloads") or {}
    if not workloads:
        problems.append("workloads missing or empty")
    roles = {"online": [], "offline": []}
    for name, w in workloads.items():
        for key in _WORKLOAD_KEYS:
            if key not in w:
                problems.append(f"workload {name!r} missing {key!r}")
        prof = w.get("profile") or {}
        for key in _PROFILE_KEYS:
            if key not in prof:
                problems.append(f"workload {name!r} profile missing {key!r}")
        if w.get("role") in roles:
            roles[w["role"]].append(name)
        else:
            problems.append(f"workload {name!r} has bad role {w.get('role')!r}")
    pairs = data.get("pairs")
    if not isinstance(pairs, list) or not pairs:
        problems.append("pairs missing or empty")
        return problems
    for p in pairs:
        tag = f"pair ({p.get('online')!r}, {p.get('offline')!r})"
        for key in _PAIR_KEYS:
            if key not in p:
                problems.append(f"{tag} missing {key!r}")
        if p.get("online") not in roles["online"]:
            problems.append(f"{tag}: online not a cataloged online workload")
        if p.get("offline") not in roles["offline"]:
            problems.append(f"{tag}: offline not a cataloged offline workload")
        shares = p.get("shares") or []
        if shares != sorted(shares):
            problems.append(f"{tag}: shares not sorted")
        if any(not 0.0 <= s <= 1.0 for s in shares):
            problems.append(f"{tag}: share outside [0, 1]")
        n = len(shares)
        for key in ("online_slowdown", "offline_tput", "achieved_share",
                    "online_p99_ms", "n_online", "n_offline",
                    "monitor_healthy_frac"):
            vals = p.get(key)
            if not isinstance(vals, list) or len(vals) != n:
                problems.append(f"{tag}: {key} length != len(shares)")
        if any(s < 1.0 - 1e-9 for s in p.get("online_slowdown") or []):
            problems.append(f"{tag}: online_slowdown < 1")
        if any(not 0.0 <= v <= 1.0 for v in p.get("offline_tput") or []):
            problems.append(f"{tag}: offline_tput outside [0, 1]")
    return problems
