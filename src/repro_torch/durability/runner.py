"""The durable run loop: WAL sink + periodic snapshots + ``--resume``.

A durable run lives in one directory (see the package docstring for the
layout).  Creation writes ``run.json`` (human-readable provenance: scenario
name, seed, engine, artifact paths, cadence) and ``scenario.pkl`` (the
fully-resolved Scenario — resume's one construction input), signs a first
manifest, then drives ``ControlPlane.run`` with a tick callback that every
``snapshot_every_s`` of sim time flushes+fsyncs the WAL, pickles a
state snapshot atomically, prunes old snapshots, and re-signs the manifest.

Resume verifies the manifest signature and the sha256 of everything it is
about to unpickle, picks the newest verifiable snapshot, rebuilds a fresh
ControlPlane from the recorded Scenario (static structure is deterministic
re-init), overwrites its mutable state from the snapshot, truncates the WAL
to the snapshot's event count, and re-runs the remaining ticks — the engine
re-emits the discarded suffix deterministically, so the final report, event
log, and obs artifacts are byte-identical to an uninterrupted run's.  A
crash before the first snapshot resumes from tick 0 the same way.

Copied from `repro/durability/runner.py`.  What the port adds is
``device=`` beside ``predictor=`` (where the predictor trains and the torch
tick engine runs: the CUDA card unless ``"cpu"``).  The device is recorded
nowhere (not in ``run.json``, ``scenario.pkl`` or the manifest), so a run
written on the card resumes on the CPU and the other way round, and
``run.json`` is byte-equal to `repro`'s.  ``scenario.pkl`` and the
snapshots pickle the port's classes, so neither package can resume a run
directory the other wrote.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import pickle

from repro_torch.durability.manifest import (build_manifest, file_sha256,
                                             verify_manifest, write_manifest)
from repro_torch.durability.snapshot import capture_control, restore_control
from repro_torch.durability.store import open_store

RUN_SCHEMA = "repro.durability.run/v1"
DEFAULT_SNAPSHOT_EVERY_S = 1800.0


def _atomic_json(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _spill_obs(obs, rundir: str):
    """A prom-only (or alerts-only) ObsConfig runs its metrics recorder on
    a digest-only (fileless) writer — which cannot be re-opened mid-stream
    on resume.  Durable runs therefore spill the metrics JSONL into the run
    directory; the stream digest (and hence the report) is unchanged."""
    if (obs is not None and (obs.prom_out or obs.alerts_out)
            and not obs.metrics_out):
        return dataclasses.replace(
            obs, metrics_out=os.path.join(rundir, "obs-metrics-spill.jsonl"))
    return obs


def _obs_dict(obs) -> dict | None:
    return None if obs is None else dataclasses.asdict(obs)


def _obs_from_dict(d: dict | None):
    if d is None:
        return None
    from repro_torch.obs import ObsConfig
    if d.get("alert_rules") is not None:
        d = dict(d, alert_rules=tuple(d["alert_rules"]))
    return ObsConfig(**d)


def _run_meta(sc, run_json_path: str) -> dict:
    sha, _ = file_sha256(run_json_path)
    return {"scenario": sc.name, "seed": sc.seed,
            "n_devices": sc.n_devices, "engine": sc.engine,
            "horizon_s": sc.horizon_seconds(), "tick_s": sc.tick_s,
            "config_sha256": sha}


class DurableRun:
    """One durable run (fresh or resumed) bound to its directory."""

    def __init__(self, rundir: str, scenario, obs, meta: dict, store):
        self.rundir = os.path.abspath(rundir)
        self.scenario = scenario
        self.obs = obs
        self.meta = meta
        self.store = store
        self.cp = None
        self.report: dict | None = None
        self.keep_snapshots = int(meta["keep_snapshots"])
        self.snapshot_every_s = float(meta["snapshot_every_s"])
        self.out = meta.get("out")
        self.snapshots_taken = 0
        self.resumed_from_tick: int | None = None
        # resume ladder: (rel_path, reason) for every snapshot that was
        # skipped as corrupt/unreadable on the way to the next good one
        self.snapshot_skips: list[tuple[str, str]] = []

    # ------------------------------------------------------------ creation
    @classmethod
    def create(cls, scenario, rundir: str, *, obs=None, out: str | None = None,
               snapshot_every_s: float = DEFAULT_SNAPSHOT_EVERY_S,
               backend: str = "jsonl", keep_snapshots: int = 3,
               segment_events: int = 50_000) -> "DurableRun":
        rundir = os.path.abspath(rundir)
        os.makedirs(rundir, exist_ok=True)
        os.makedirs(os.path.join(rundir, "snapshots"), exist_ok=True)
        obs = _spill_obs(obs, rundir)
        meta = {"schema": RUN_SCHEMA, "scenario": scenario.name,
                "seed": scenario.seed, "n_devices": scenario.n_devices,
                "engine": scenario.engine, "tick_s": scenario.tick_s,
                "horizon_s": scenario.horizon_seconds(),
                "snapshot_every_s": float(snapshot_every_s),
                "backend": backend, "keep_snapshots": int(keep_snapshots),
                "segment_events": int(segment_events),
                "out": out, "obs": _obs_dict(obs)}
        _atomic_json(os.path.join(rundir, "run.json"), meta)
        with open(os.path.join(rundir, "scenario.pkl"), "wb") as f:
            pickle.dump(scenario, f)
        store = open_store(os.path.join(rundir, "events"), backend,
                           segment_events=segment_events)
        run = cls(rundir, scenario, obs, meta, store)
        run._write_manifest(final=False)     # present before any snapshot
        return run

    # -------------------------------------------------------------- resume
    @classmethod
    def open(cls, rundir: str) -> "DurableRun":
        """Open an existing run directory for resume.  Verifies the
        manifest signature and the hash of every pickle before loading."""
        rundir = os.path.abspath(rundir)
        run_json = os.path.join(rundir, "run.json")
        if not os.path.exists(run_json):
            raise FileNotFoundError(f"no run.json in {rundir} — not a "
                                    "durable run directory")
        with open(run_json) as f:
            meta = json.load(f)
        if meta.get("schema") != RUN_SCHEMA:
            raise ValueError(f"unexpected run.json schema "
                             f"{meta.get('schema')!r}")
        manifest_path = os.path.join(rundir, "manifest.json")
        problems = verify_manifest(manifest_path, check_files=False)
        if problems:
            raise ValueError("manifest verification failed: "
                             + "; ".join(problems))
        with open(manifest_path) as f:
            manifest = json.load(f)
        cls._check_listed(manifest, rundir, "scenario.pkl")
        with open(os.path.join(rundir, "scenario.pkl"), "rb") as f:
            scenario = pickle.load(f)
        obs = _obs_from_dict(meta.get("obs"))
        store = open_store(os.path.join(rundir, "events"),
                           meta.get("backend", "jsonl"),
                           segment_events=meta.get("segment_events", 50_000))
        run = cls(rundir, scenario, obs, meta, store)
        run._manifest = manifest
        return run

    @staticmethod
    def _check_listed(manifest: dict, rundir: str, rel: str) -> None:
        entry = manifest.get("artifacts", {}).get(rel)
        if entry is None:
            raise ValueError(f"{rel} not listed in the manifest")
        sha, size = file_sha256(os.path.join(rundir, rel))
        if sha != entry["sha256"] or size != entry["bytes"]:
            raise ValueError(f"{rel} does not match its manifest hash")

    def _pick_snapshot(self) -> tuple[str, dict] | None:
        """Newest snapshot that exists, matches its manifest hash, and
        actually unpickles — **skip-to-next-good**: a snapshot written
        after the last manifest refresh (crash inside the snapshot step),
        hash-mismatched, or corrupt-but-hash-consistent (bad bytes made it
        to disk before signing) is recorded in ``snapshot_skips`` and the
        search continues with the previous one, which is still a valid
        resume point (resume just re-runs more ticks)."""
        listed = getattr(self, "_manifest", {}).get("artifacts", {})
        paths = sorted(glob.glob(
            os.path.join(self.rundir, "snapshots", "snap-*.pkl")),
            reverse=True)
        for path in paths:
            rel = os.path.relpath(path, self.rundir)
            entry = listed.get(rel)
            if entry is None:
                continue      # newer than the manifest — normal, not logged
            sha, size = file_sha256(path)
            if sha != entry["sha256"] or size != entry["bytes"]:
                self.snapshot_skips.append((rel, "manifest hash mismatch"))
                continue
            try:
                with open(path, "rb") as f:
                    snap = pickle.load(f)
            except Exception as exc:    # any unpickling failure mode
                self.snapshot_skips.append((rel, f"unreadable: {exc}"))
                continue
            if not isinstance(snap, dict) or "tick_i" not in snap:
                self.snapshot_skips.append((rel, "not a snapshot payload"))
                continue
            return path, snap
        return None

    # ----------------------------------------------------------- run loops
    def _n_ticks(self) -> int:
        sc = self.scenario
        return int(sc.horizon_seconds() / sc.tick_s)

    def _every_ticks(self) -> int:
        return max(1, int(round(self.snapshot_every_s / self.scenario.tick_s)))

    def _tick_callback(self):
        every, n_ticks = self._every_ticks(), self._n_ticks()

        def cb(ticks_done: int, t: float) -> None:
            if ticks_done % every == 0 and ticks_done < n_ticks:
                self._snapshot(ticks_done, t)
        return cb

    def execute(self, predictor=None, *, at_tick: int | None = None,
                device=None) -> dict:
        """Run to completion — fresh if no usable snapshot exists, resumed
        otherwise (``at_tick`` pins a specific snapshot, for benchmarks).
        ``device`` places the card work (None: the CUDA card).  Returns the
        deterministic campaign report."""
        from repro_torch.cluster.control import ControlPlane
        picked = None
        if at_tick is not None:
            path = os.path.join(self.rundir, "snapshots",
                                f"snap-{at_tick:07d}.pkl")
            self._check_listed(getattr(self, "_manifest", {"artifacts": {}}),
                               self.rundir,
                               os.path.relpath(path, self.rundir))
            with open(path, "rb") as f:
                picked = (path, pickle.load(f))
        elif hasattr(self, "_manifest"):
            picked = self._pick_snapshot()
        if picked is None:
            # fresh start (or crash before the first snapshot): discard any
            # WAL prefix and run from tick 0
            self.store.truncate(0)
            self.cp = ControlPlane(self.scenario, predictor=predictor,
                                   obs=self.obs, device=device)
            self.store.fault_injector = getattr(self.cp, "chaos", None)
            self.cp.bus.attach_sink(self.store.append)
            self.cp.run(tick_callback=self._tick_callback())
        else:
            _path, snap = picked
            self.resumed_from_tick = snap["tick_i"]
            prefixes = self._read_obs_prefixes(snap)
            self.cp = ControlPlane(self.scenario, predictor=predictor,
                                   obs=self.obs, device=device)
            self.store.fault_injector = getattr(self.cp, "chaos", None)
            restore_control(self.cp, snap, store=self.store,
                            obs_prefixes=prefixes)
            self.store.truncate(snap["bus"]["n_events"])
            self.cp.bus.attach_sink(self.store.append)
            self.cp.run(start_tick=snap["tick_i"], start_t=snap["t"],
                        tick_callback=self._tick_callback())
        self.store.flush()
        self.report = self.cp.report()
        return self.report

    def _read_obs_prefixes(self, snap: dict) -> dict:
        """Surviving obs file prefixes, read BEFORE ControlPlane
        construction truncates the output files."""
        prefixes: dict[str, bytes] = {}
        obs_snap = snap.get("obs")
        if not obs_snap or self.obs is None:
            return prefixes
        for key, path in (("metrics", self.obs.metrics_out),
                          ("trace", self.obs.trace_out),
                          ("alerts", self.obs.alerts_out)):
            part = obs_snap.get(key)
            if part is None:
                continue
            offset = part["writer"]["offset"]
            if offset is None or path is None:
                raise ValueError(
                    f"snapshot has a fileless obs {key} writer — durable "
                    "runs require file-backed obs outputs")
            with open(path, "rb") as f:
                data = f.read(offset)
            if len(data) != offset:
                raise ValueError(
                    f"obs {key} file {path} shorter ({len(data)}B) than "
                    f"its snapshot offset ({offset}B)")
            prefixes[key] = data
        return prefixes

    # ------------------------------------------------------------ snapshot
    def _snapshot(self, tick_i: int, t: float) -> None:
        self.store.flush(fsync=True)
        snap = capture_control(self.cp, t, tick_i)
        path = os.path.join(self.rundir, "snapshots",
                            f"snap-{tick_i:07d}.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(snap, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.snapshots_taken += 1
        self._prune_snapshots()
        self._write_manifest(final=False)

    def _prune_snapshots(self) -> None:
        paths = sorted(glob.glob(
            os.path.join(self.rundir, "snapshots", "snap-*.pkl")))
        for path in paths[:-self.keep_snapshots]:
            os.unlink(path)

    # ------------------------------------------------------------ manifest
    def _artifacts(self, final: bool) -> list[str]:
        arts = [os.path.join(self.rundir, "run.json"),
                os.path.join(self.rundir, "scenario.pkl")]
        arts += sorted(glob.glob(
            os.path.join(self.rundir, "snapshots", "snap-*.pkl")))
        if final:
            arts += sorted(glob.glob(
                os.path.join(self.rundir, "events", "*")))
            if self.out:
                arts.append(self.out)
            if self.obs is not None:
                arts += [p for p in (self.obs.metrics_out,
                                     self.obs.trace_out, self.obs.prom_out,
                                     self.obs.alerts_out)
                         if p]
        return arts

    def _write_manifest(self, final: bool) -> None:
        meta = _run_meta(self.scenario, os.path.join(self.rundir, "run.json"))
        meta["final"] = bool(final)
        manifest = build_manifest(self.rundir, self._artifacts(final), meta)
        write_manifest(os.path.join(self.rundir, "manifest.json"), manifest)
        self._manifest = manifest

    def finalize_manifest(self) -> None:
        """Seal the run: close the WAL and sign the complete artifact set
        (event segments, report, obs outputs).  Call after the report file
        has been written."""
        self.store.close()
        self._write_manifest(final=True)


def run_durable(scenario, rundir: str, *, obs=None, out: str | None = None,
                snapshot_every_s: float = DEFAULT_SNAPSHOT_EVERY_S,
                backend: str = "jsonl", keep_snapshots: int = 3,
                predictor=None, device=None) -> DurableRun:
    """Fresh durable run; returns the :class:`DurableRun` with its
    ``report`` populated (call ``finalize_manifest()`` once the report
    file is written)."""
    run = DurableRun.create(scenario, rundir, obs=obs, out=out,
                            snapshot_every_s=snapshot_every_s,
                            backend=backend, keep_snapshots=keep_snapshots)
    run.execute(predictor=predictor, device=device)
    return run


def resume_run(rundir: str, *, at_tick: int | None = None,
               predictor=None, device=None) -> DurableRun:
    """Resume (or restart, if no snapshot survived) a durable run."""
    run = DurableRun.open(rundir)
    run.execute(predictor=predictor, at_tick=at_tick, device=device)
    return run


def verify_rundir(manifest_path: str) -> list[str]:
    """The ``--verify-manifest`` CLI: manifest signature + artifact hashes,
    plus the WAL's per-segment chain when the directory holds one."""
    problems = verify_manifest(manifest_path)
    rundir = os.path.dirname(os.path.abspath(manifest_path))
    events = os.path.join(rundir, "events")
    if os.path.isdir(events):
        try:
            with open(os.path.join(rundir, "run.json")) as f:
                backend = json.load(f).get("backend", "jsonl")
        except OSError:
            backend = "jsonl"
        store = open_store(events, backend)
        try:
            problems += store.verify()
        finally:
            store.close()
    return problems
