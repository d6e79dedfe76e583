"""WAL diffing: pinpoint the first divergent event between two runs.

``diff_runs(A, B)`` is the regression tool the ROADMAP asked for: given two
durable run directories (e.g. the same scenario before and after a code
change, or two seeds suspected identical), it locates the exact first event
where the WALs part ways — without reading both streams end to end.

The per-segment sha256 chain (``chain_k = sha256(chain_{k-1} +
sha256(seg_k))``) makes chain equality at index ``k`` equivalent to "every
sealed segment through ``k`` is byte-identical", a monotone predicate — so
a binary search over the common sealed prefix finds the first mismatched
segment in O(log segments) hash comparisons.  Only that one segment (or
the unsealed tail, when every common sealed segment matches) is then read
event-by-event, comparing :meth:`Event.key` — the exact tuple the bus's
running digest hashes.

The report carries the divergent seq/tick, both events, a context window
of surrounding events from each run, and — when the runs recorded alerts —
each run's incident timeline open at the divergence tick, so a behavioral
regression lands next to the operator-facing harm it caused.

Copied from `repro/durability/diff.py` with the same behaviour (the WAL
only: no device).
"""
from __future__ import annotations

import itertools
import json
import os

from repro_torch.durability.store import _row_of, open_store
from repro_torch.obs.alerts import incidents_open_at, read_incidents

DIFF_SCHEMA = "repro.durability.diff/v1"


def _open_rundir(rundir: str):
    run_json = os.path.join(rundir, "run.json")
    if not os.path.exists(run_json):
        raise FileNotFoundError(f"no run.json in {rundir} — not a durable "
                                "run directory")
    with open(run_json) as f:
        meta = json.load(f)
    store = open_store(os.path.join(rundir, "events"),
                       meta.get("backend", "jsonl"),
                       segment_events=meta.get("segment_events", 50_000))
    return meta, store


def _first_mismatched_segment(chain_a: list, chain_b: list) -> int:
    """Binary-search the sealed chains: the first common index whose chain
    hash differs, or ``min(len_a, len_b)`` when every common sealed
    segment matches (chain equality at k ⟺ the whole prefix through k is
    identical, so the predicate is monotone)."""
    lo, hi = 0, min(len(chain_a), len(chain_b))
    while lo < hi:
        mid = (lo + hi) // 2
        if chain_a[mid]["chain"] == chain_b[mid]["chain"]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _incident_timeline(rundir: str, meta: dict):
    path = (meta.get("obs") or {}).get("alerts_out")
    if path and os.path.exists(path):
        return read_incidents(path)
    return None


def diff_runs(rundir_a: str, rundir_b: str, *, context: int = 3) -> dict:
    """Compare two durable runs' WALs; see module docstring.  The returned
    document has ``identical=True`` and ``first_divergence=None`` when the
    event streams match in full."""
    meta_a, store_a = _open_rundir(rundir_a)
    meta_b, store_b = _open_rundir(rundir_b)
    try:
        chain_a, chain_b = store_a.chain(), store_b.chain()
        n_a, n_b = store_a.count(), store_b.count()
        # chain bisection assumes identical segmentation; with different
        # segment sizes the hashes are incomparable — fall back to a scan
        comparable = (meta_a.get("segment_events")
                      == meta_b.get("segment_events"))
        k = _first_mismatched_segment(chain_a, chain_b) if comparable else 0
        sealed_mismatch = (comparable
                           and k < min(len(chain_a), len(chain_b)))
        if sealed_mismatch:
            # divergence is inside sealed segment k (its prefix matched)
            start = chain_a[k]["start"]
            stop = start + max(chain_a[k]["n"], chain_b[k]["n"])
        else:
            # all common sealed segments match: scan the remainder (the
            # unsealed tail, or the longer run's extra segments)
            start = (chain_a[k - 1]["start"] + chain_a[k - 1]["n"]
                     if k else 0)
            stop = None
        div_seq = None
        ev_a = ev_b = None
        for a, b in itertools.zip_longest(store_a.read(start, stop),
                                          store_b.read(start, stop)):
            if a is None or b is None or a.key() != b.key():
                div_seq = (a if a is not None else b).seq
                ev_a, ev_b = a, b
                break
        doc = {
            "schema": DIFF_SCHEMA,
            "a": _run_cell(meta_a, n_a, len(chain_a)),
            "b": _run_cell(meta_b, n_b, len(chain_b)),
            "identical": div_seq is None,
            "sealed_segments_compared": (min(len(chain_a), len(chain_b))
                                         if comparable else 0),
            "first_mismatched_segment": k if sealed_mismatch else None,
            "first_divergence": None,
            "incidents_at_divergence": None,
        }
        if div_seq is None:
            return doc
        t_div = (ev_a if ev_a is not None else ev_b).t
        ctx_start = max(start, div_seq - context)
        ctx_stop = div_seq + context + 1
        tick_s = meta_a.get("tick_s") or 1.0
        doc["first_divergence"] = {
            "seq": div_seq,
            "t": t_div,
            "tick": int(t_div / tick_s),
            "event_a": _row_of(ev_a) if ev_a is not None else None,
            "event_b": _row_of(ev_b) if ev_b is not None else None,
            "context_a": [_row_of(e)
                          for e in store_a.read(ctx_start, ctx_stop)],
            "context_b": [_row_of(e)
                          for e in store_b.read(ctx_start, ctx_stop)],
        }
        inc = {}
        for side, rundir, meta in (("a", rundir_a, meta_a),
                                   ("b", rundir_b, meta_b)):
            timeline = _incident_timeline(rundir, meta)
            inc[side] = None if timeline is None else {
                "total": len(timeline),
                "open_at_t": [i.row() for i in
                              incidents_open_at(timeline, t_div)],
            }
        if inc["a"] is not None or inc["b"] is not None:
            doc["incidents_at_divergence"] = inc
        return doc
    finally:
        store_a.close()
        store_b.close()


def _run_cell(meta: dict, n_events: int, n_sealed: int) -> dict:
    return {"scenario": meta.get("scenario"), "seed": meta.get("seed"),
            "engine": meta.get("engine"),
            "n_devices": meta.get("n_devices"),
            "n_events": n_events, "sealed_segments": n_sealed}


def format_diff(doc: dict) -> str:
    """A short human-readable digest (stderr; the JSON document is the
    machine-readable artifact)."""
    a, b = doc["a"], doc["b"]
    head = (f"A: {a['scenario']} seed={a['seed']} engine={a['engine']} "
            f"({a['n_events']} events)\n"
            f"B: {b['scenario']} seed={b['seed']} engine={b['engine']} "
            f"({b['n_events']} events)")
    if doc["identical"]:
        return head + "\nno divergence: event streams are identical"
    fd = doc["first_divergence"]
    lines = [head,
             f"first divergence at seq {fd['seq']} "
             f"(t={fd['t']:.1f}s, tick {fd['tick']})"]
    for side in ("a", "b"):
        ev = fd[f"event_{side}"]
        lines.append(f"  {side}: " + ("<stream ended>" if ev is None else
                                      f"{ev['kind']} device={ev['device']} "
                                      f"job={ev['job']} data={ev['data']}"))
    inc = doc.get("incidents_at_divergence")
    if inc:
        for side in ("a", "b"):
            cell = inc[side]
            if cell is not None:
                lines.append(f"  incidents open in {side} at divergence: "
                             f"{len(cell['open_at_t'])} "
                             f"(of {cell['total']} total)")
    return "\n".join(lines)
