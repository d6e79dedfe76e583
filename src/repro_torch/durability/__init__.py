"""Durable, event-sourced control plane: WAL + snapshots + signed manifests.

The determinism substrate (gapless event sequences, SHA-256 stream digests,
byte-identical numpy/torch reports) makes crash recovery *provable*: persist
the event stream and periodic state snapshots, and a run killed at an
arbitrary tick can be resumed to a final report that is byte-identical to
an uninterrupted same-seed run.

Layout of a durable run directory::

    rundir/
      run.json              # provenance: scenario, seed, engine, artifact paths
      scenario.pkl          # the fully-resolved Scenario (resume input)
      events/
        segment-000000.jsonl  # append-only WAL segments (or log.sqlite)
        index.json            # sealed-segment sha256 chain
      snapshots/
        snap-0000360.pkl      # tick-boundary state snapshots
      manifest.json         # artifact sha256s + HMAC signature

Modules:

* :mod:`~repro_torch.durability.store` — ``EventStore`` API with JSONL-segment and
  sqlite backends; per-segment SHA-256 chain hashes.
* :mod:`~repro_torch.durability.snapshot` — capture/restore of the mutable state of
  ClusterSim, ControlPlane, ServingPlane, and the obs plane's mid-stream
  writers.
* :mod:`~repro_torch.durability.manifest` — HMAC-SHA256 signed run manifests.
* :mod:`~repro_torch.durability.runner` — the durable run loop and ``--resume``.
* :mod:`~repro_torch.durability.inspect` — time-travel: replay to an arbitrary
  tick and summarize the live state (``python -m repro_torch inspect``).
* :mod:`~repro_torch.durability.diff` — pinpoint the first divergent WAL event
  between two runs via chain bisection (``python -m repro_torch diff``).

Copied from `repro/durability`; under one predictor the WAL segments,
``index.json`` and the forensics documents are byte-equal to `repro`'s.  A
run directory resumes only in the package that wrote it (see ``runner``).
"""
from repro_torch.durability.diff import DIFF_SCHEMA, diff_runs, format_diff
from repro_torch.durability.inspect import (INSPECT_SCHEMA, build_paused,
                                            dump_inspection, inspect_run)
from repro_torch.durability.manifest import (sign_manifest, verify_manifest,
                                             write_manifest)
from repro_torch.durability.runner import (DurableRun, resume_run, run_durable,
                                           verify_rundir)
from repro_torch.durability.snapshot import (capture_sim, restore_sim,
                                             capture_control, restore_control)
from repro_torch.durability.store import (JsonlEventStore, SqliteEventStore,
                                          open_store)

__all__ = [
    "JsonlEventStore", "SqliteEventStore", "open_store",
    "capture_sim", "restore_sim", "capture_control", "restore_control",
    "sign_manifest", "verify_manifest", "write_manifest",
    "DurableRun", "run_durable", "resume_run", "verify_rundir",
    "INSPECT_SCHEMA", "inspect_run", "build_paused", "dump_inspection",
    "DIFF_SCHEMA", "diff_runs", "format_diff",
]
