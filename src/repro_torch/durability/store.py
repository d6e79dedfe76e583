"""Write-ahead event stores: JSONL segments and sqlite, one API.

An :class:`EventStore` persists the control plane's full event stream with
enough fidelity that the bus's running SHA-256 digest can be rebuilt by
replaying the stored prefix — ``Event.key()`` round-trips exactly because
rows are serialized with shortest-repr floats (plain ``json``, *not* the
obs plane's rounding canonicalizer).

The JSONL backend appends to numbered segment files and seals a segment
every ``segment_events`` rows, recording its SHA-256 plus a chain hash
``chain_k = sha256(chain_{k-1} + sha256(segment_k))`` in ``index.json`` —
any retroactive edit to a sealed segment breaks every later chain link.
The sqlite backend stores the same rows in one table and maintains the
same logical chain over virtual segments, so either backend can verify
the other's guarantee.  ``truncate(n)`` discards a torn/stale suffix on
resume; re-running the remaining ticks re-emits that suffix
deterministically, so the final log is byte-identical to an
uninterrupted run's.

Copied from `repro/durability/store.py` with the same behaviour.
"""
from __future__ import annotations

import hashlib
import json
import os
import sqlite3

from repro_torch.cluster.events import Event, EventKind

_GENESIS = "0" * 64


def _row_of(ev: Event) -> dict:
    return {"seq": ev.seq, "t": ev.t, "kind": ev.kind.value,
            "device": ev.device, "job": ev.job,
            "data": [[k, v] for k, v in ev.data]}


def _event_of(row: dict) -> Event:
    return Event(row["seq"], row["t"], EventKind(row["kind"]),
                 row["device"], row["job"],
                 tuple((k, tuple(v) if isinstance(v, list) else v)
                       for k, v in row["data"]))


def _dumps(row: dict) -> str:
    # shortest-repr floats (exact round-trip) — never the obs canonicalizer
    return json.dumps(row, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def _chain(prev_hex: str, seg_sha_hex: str) -> str:
    return hashlib.sha256((prev_hex + seg_sha_hex).encode()).hexdigest()


def _atomic_write(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class EventStore:
    """Append-only, truncatable, digest-reconstructable event log.

    Append/flush/fsync run under a **bounded deterministic retry ladder**
    (:meth:`_io`): a transient IO error is retried immediately — never a
    sleep, the artifact clock is sim time — up to ``max_io_retries`` times
    before it propagates.  The optional ``fault_injector`` seam (anything
    with ``store_fault(op)`` / ``note_io_recovered(op, attempts)``, see
    :class:`repro_torch.chaos.FaultInjector`) fires *before* the real operation,
    so an injected fault never leaves a partial write behind and a retried
    append never duplicates a row.
    """

    #: chaos seam; None = the byte-identical no-chaos path
    fault_injector = None
    #: retries per IO operation before the error propagates
    max_io_retries = 3
    #: transient IO faults encountered (injected + real)
    io_faults = 0
    #: retry attempts that eventually succeeded
    io_retries = 0

    def _io(self, op: str, fn, exc=(OSError,)):
        """Run one IO operation under the bounded retry ladder."""
        inj = self.fault_injector
        attempts = 0
        while True:
            try:
                if inj is not None and inj.store_fault(op):
                    raise OSError(f"injected transient WAL {op} fault")
                out = fn()
            except exc:
                self.io_faults += 1
                if attempts >= self.max_io_retries:
                    raise
                attempts += 1
                self.io_retries += 1
                continue
            if attempts and inj is not None:
                note = getattr(inj, "note_io_recovered", None)
                if note is not None:
                    note(op, attempts)
            return out

    def append(self, ev: Event) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def abandon(self) -> None:
        """Drop the store handle WITHOUT durably closing — the chaos
        harness's in-process stand-in for SIGKILL.  JSONL: buffered bytes
        reach the file (the OS page cache would usually hold them) but
        nothing is fsynced or sealed; sqlite: the uncommitted suffix is
        rolled back and lost, the torn-write analog."""
        raise NotImplementedError

    def read(self, start: int = 0, stop: int | None = None):
        """Yield stored :class:`Event` objects for ``seq in [start, stop)``.
        Tolerates a torn final line (SIGKILL mid-write)."""
        raise NotImplementedError

    def count(self) -> int:
        raise NotImplementedError

    def truncate(self, n: int) -> None:
        """Drop every event with ``seq >= n`` (resume discards the
        post-snapshot suffix, then re-emits it by re-running ticks)."""
        raise NotImplementedError

    def chain(self) -> list[dict]:
        """Sealed-segment records: ``{file, start, n, sha256, chain}``."""
        raise NotImplementedError

    def verify(self) -> list[str]:
        """Re-hash sealed segments against the recorded chain; return
        human-readable problems (empty list == intact)."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    # ---------------------------------------------------------------- digest
    def replay_digest(self, n: int) -> "hashlib._Hash":
        """Rebuild the EventBus's running sha256 over events ``[0, n)`` —
        byte-exact because ``Event.key()`` round-trips through storage."""
        h = hashlib.sha256()
        for ev in self.read(0, n):
            h.update(repr(ev.key()).encode())
        return h


class JsonlEventStore(EventStore):
    """Append-only JSONL segments with a sha256 chain over sealed files."""

    INDEX = "index.json"

    def __init__(self, root: str, segment_events: int = 50_000):
        self.root = root
        self.segment_events = segment_events
        os.makedirs(root, exist_ok=True)
        self._sealed: list[dict] = []
        self._open_start = 0     # first seq of the open segment
        self._open_n = 0         # rows in the open segment
        self._n = 0              # total events
        idx_path = os.path.join(root, self.INDEX)
        if os.path.exists(idx_path):
            with open(idx_path) as f:
                idx = json.load(f)
            self._sealed = idx["segments"]
            self.segment_events = idx.get("segment_events",
                                          self.segment_events)
            self._open_start = (self._sealed[-1]["start"]
                                + self._sealed[-1]["n"]
                                if self._sealed else 0)
        # recover the open segment (which exists before any index does):
        # rewrite it from its parseable rows, dropping a torn tail from a
        # SIGKILL mid-write
        if os.path.exists(self._seg_path(self._open_start)):
            rows = list(self._read_segment(self._seg_path(self._open_start)))
            _atomic_write(self._seg_path(self._open_start),
                          "".join(_dumps(r) + "\n" for r in rows))
            self._open_n = len(rows)
        self._n = self._open_start + self._open_n
        self._f = open(self._seg_path(self._open_start), "a")

    # ------------------------------------------------------------- internals
    def _seg_path(self, start_seq: int) -> str:
        return os.path.join(self.root, f"segment-{start_seq:09d}.jsonl")

    @staticmethod
    def _read_segment(path: str):
        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    return     # torn tail from a SIGKILL mid-write

    def _seal(self) -> None:
        """Close the full open segment, record its chain link, start anew."""
        self._f.close()
        path = self._seg_path(self._open_start)
        with open(path, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        prev = self._sealed[-1]["chain"] if self._sealed else _GENESIS
        self._sealed.append({
            "file": os.path.basename(path), "start": self._open_start,
            "n": self._open_n, "sha256": sha, "chain": _chain(prev, sha)})
        self._write_index()
        self._open_start = self._n
        self._open_n = 0
        self._f = open(self._seg_path(self._open_start), "a")

    def _write_index(self) -> None:
        _atomic_write(os.path.join(self.root, self.INDEX), _dumps(
            {"schema": "repro.durability.wal/v1",
             "backend": "jsonl",
             "segment_events": self.segment_events,
             "segments": self._sealed}) + "\n")

    # -------------------------------------------------------------- EventStore
    def append(self, ev: Event) -> None:
        if ev.seq != self._n:
            raise ValueError(f"WAL gap: expected seq {self._n}, got {ev.seq}")
        line = _dumps(_row_of(ev)) + "\n"
        self._io("append", lambda: self._f.write(line))
        self._n += 1
        self._open_n += 1
        if self._open_n >= self.segment_events:
            self._seal()

    def flush(self, fsync: bool = True) -> None:
        self._io("flush", self._f.flush)
        if fsync:
            self._io("fsync", lambda: os.fsync(self._f.fileno()))

    def read(self, start: int = 0, stop: int | None = None):
        self._f.flush()
        starts = [s["start"] for s in self._sealed] + [self._open_start]
        for s0 in starts:
            for row in self._read_segment(self._seg_path(s0)):
                if stop is not None and row["seq"] >= stop:
                    return
                if row["seq"] >= start:
                    yield _event_of(row)

    def count(self) -> int:
        return self._n

    def truncate(self, n: int) -> None:
        if n > self._n:
            raise ValueError(f"WAL truncate({n}) beyond {self._n} events")
        self._f.close()
        # keep fully-surviving sealed segments; everything later is folded
        # into one rewritten open segment holding rows [new_start, n)
        keep: list[dict] = []
        for seg in self._sealed:
            if seg["start"] + seg["n"] <= n:
                keep.append(seg)
            else:
                break
        new_start = keep[-1]["start"] + keep[-1]["n"] if keep else 0
        survivors: list[dict] = []
        for seg in self._sealed[len(keep):]:
            path = os.path.join(self.root, seg["file"])
            survivors.extend(r for r in self._read_segment(path)
                             if r["seq"] < n)
            os.unlink(path)
        old_open = self._seg_path(self._open_start)
        if os.path.exists(old_open):
            survivors.extend(r for r in self._read_segment(old_open)
                             if r["seq"] < n)
            os.unlink(old_open)
        survivors = sorted((r for r in survivors if r["seq"] >= new_start),
                           key=lambda r: r["seq"])
        _atomic_write(self._seg_path(new_start),
                      "".join(_dumps(r) + "\n" for r in survivors))
        self._sealed = keep
        self._open_start = new_start
        self._open_n = len(survivors)
        self._n = new_start + self._open_n
        if self._n != n:
            raise ValueError(f"WAL truncate({n}) left {self._n} events")
        self._write_index()
        self._f = open(self._seg_path(new_start), "a")

    def chain(self) -> list[dict]:
        return list(self._sealed)

    def verify(self) -> list[str]:
        problems: list[str] = []
        prev = _GENESIS
        for seg in self._sealed:
            path = os.path.join(self.root, seg["file"])
            if not os.path.exists(path):
                problems.append(f"missing sealed segment {seg['file']}")
                continue
            with open(path, "rb") as f:
                sha = hashlib.sha256(f.read()).hexdigest()
            if sha != seg["sha256"]:
                problems.append(f"segment {seg['file']} sha256 mismatch")
            if _chain(prev, seg["sha256"]) != seg["chain"]:
                problems.append(f"segment {seg['file']} chain link broken")
            prev = seg["chain"]
        return problems

    def close(self) -> None:
        self.flush()
        self._f.close()

    def abandon(self) -> None:
        self._f.flush()
        self._f.close()


class SqliteEventStore(EventStore):
    """Same API over one sqlite file; the chain covers virtual segments of
    ``segment_events`` rows so the tamper-evidence guarantee matches the
    JSONL backend's."""

    DB = "log.sqlite"

    def __init__(self, root: str, segment_events: int = 50_000):
        self.root = root
        self.segment_events = segment_events
        os.makedirs(root, exist_ok=True)
        self._db = sqlite3.connect(os.path.join(root, self.DB))
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS events ("
            "seq INTEGER PRIMARY KEY, row TEXT NOT NULL)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS chain ("
            "seg INTEGER PRIMARY KEY, start INTEGER, n INTEGER, "
            "sha256 TEXT, chain TEXT)")
        cur = self._db.execute("SELECT COALESCE(MAX(seq)+1, 0) FROM events")
        self._n = int(cur.fetchone()[0])
        cur = self._db.execute(
            "SELECT COALESCE(MAX(start+n), 0) FROM chain")
        self._sealed_upto = int(cur.fetchone()[0])

    def _seal_virtual(self) -> None:
        start = self._sealed_upto
        h = hashlib.sha256()
        for (row,) in self._db.execute(
                "SELECT row FROM events WHERE seq >= ? AND seq < ? "
                "ORDER BY seq", (start, start + self.segment_events)):
            h.update((row + "\n").encode())
        sha = h.hexdigest()
        cur = self._db.execute(
            "SELECT chain FROM chain ORDER BY seg DESC LIMIT 1")
        got = cur.fetchone()
        prev = got[0] if got else _GENESIS
        cur = self._db.execute("SELECT COALESCE(MAX(seg)+1, 0) FROM chain")
        seg = int(cur.fetchone()[0])
        self._db.execute(
            "INSERT INTO chain (seg, start, n, sha256, chain) "
            "VALUES (?, ?, ?, ?, ?)",
            (seg, start, self.segment_events, sha, _chain(prev, sha)))
        self._sealed_upto = start + self.segment_events

    _IO_ERRORS = (OSError, sqlite3.OperationalError)

    def append(self, ev: Event) -> None:
        if ev.seq != self._n:
            raise ValueError(f"WAL gap: expected seq {self._n}, got {ev.seq}")
        row = _dumps(_row_of(ev))
        self._io("append",
                 lambda: self._db.execute(
                     "INSERT INTO events (seq, row) VALUES (?, ?)",
                     (ev.seq, row)),
                 exc=self._IO_ERRORS)
        self._n += 1
        if self._n - self._sealed_upto >= self.segment_events:
            self._seal_virtual()

    def flush(self, fsync: bool = True) -> None:
        self._io("fsync", self._db.commit, exc=self._IO_ERRORS)

    def read(self, start: int = 0, stop: int | None = None):
        q = "SELECT row FROM events WHERE seq >= ?"
        params: list = [start]
        if stop is not None:
            q += " AND seq < ?"
            params.append(stop)
        for (row,) in self._db.execute(q + " ORDER BY seq", params):
            yield _event_of(json.loads(row))

    def count(self) -> int:
        return self._n

    def truncate(self, n: int) -> None:
        self._db.execute("DELETE FROM events WHERE seq >= ?", (n,))
        self._db.execute("DELETE FROM chain WHERE start + n > ?", (n,))
        self._db.commit()
        cur = self._db.execute("SELECT COALESCE(MAX(seq)+1, 0) FROM events")
        self._n = int(cur.fetchone()[0])
        cur = self._db.execute("SELECT COALESCE(MAX(start+n), 0) FROM chain")
        self._sealed_upto = int(cur.fetchone()[0])

    def chain(self) -> list[dict]:
        return [{"file": self.DB, "start": int(s), "n": int(nn),
                 "sha256": sha, "chain": ch}
                for s, nn, sha, ch in self._db.execute(
                    "SELECT start, n, sha256, chain FROM chain "
                    "ORDER BY seg")]

    def verify(self) -> list[str]:
        problems: list[str] = []
        prev = _GENESIS
        for seg in self.chain():
            h = hashlib.sha256()
            for (row,) in self._db.execute(
                    "SELECT row FROM events WHERE seq >= ? AND seq < ? "
                    "ORDER BY seq", (seg["start"], seg["start"] + seg["n"])):
                h.update((row + "\n").encode())
            if h.hexdigest() != seg["sha256"]:
                problems.append(
                    f"virtual segment @{seg['start']} sha256 mismatch")
            if _chain(prev, seg["sha256"]) != seg["chain"]:
                problems.append(
                    f"virtual segment @{seg['start']} chain link broken")
            prev = seg["chain"]
        return problems

    def close(self) -> None:
        self._db.commit()
        self._db.close()

    def abandon(self) -> None:
        self._db.rollback()
        self._db.close()


BACKENDS = ("jsonl", "sqlite")


def open_store(root: str, backend: str = "jsonl",
               segment_events: int = 50_000) -> EventStore:
    if backend == "jsonl":
        return JsonlEventStore(root, segment_events=segment_events)
    if backend == "sqlite":
        return SqliteEventStore(root, segment_events=segment_events)
    raise ValueError(f"unknown event-store backend {backend!r} "
                     f"(expected one of {BACKENDS})")
