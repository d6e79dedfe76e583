"""Deterministic exporters: canonical JSONL and Prometheus text format.

Every observability artifact follows the repo's byte-identity discipline:
rows carry **sim time only** (never wall clock), floats are rounded to a
fixed precision, JSON keys are sorted, and writers keep a running SHA-256
digest of exactly the bytes they emit — so "same seed ⇒ same bytes" is
checkable without re-reading files (the report's ``obs`` section carries the
digests, CI ``cmp``s the files across processes and across tick engines).

Writers stream: a row is serialized, hashed, and written immediately, so a
20k-GPU × 12 h run never holds its timeseries in memory.

Copied from `repro/obs/export.py` with the same behaviour.
"""
from __future__ import annotations

import hashlib
import json
import math
import re

_NDIGITS = 9            # float rounding in canonical rows (< 1 ns of sim time)

METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _canon(obj):
    """Recursively round floats (rejecting non-finite values — they have no
    canonical JSON form) and normalize ``-0.0`` so equal values serialize to
    equal bytes.

    Dispatches on exact type first: rows are overwhelmingly flat dicts of
    ``str``/``int``/``float``, and this runs once per streamed row (hundreds
    of thousands of trace rows in a full campaign).  Exact-type checks also
    sidestep the bool-is-an-int subclass trap (``type(True) is bool``)."""
    t = type(obj)
    if t is str or t is int:
        return obj
    if t is float:
        if not math.isfinite(obj):
            raise ValueError(f"non-finite value in canonical row: {obj!r}")
        return round(obj, _NDIGITS) + 0.0
    if t is dict:
        return {k: _canon(v) for k, v in obj.items()}
    if t is list or t is tuple:
        return [_canon(v) for v in obj]
    if obj is None or t is bool:
        return obj
    # subclasses (e.g. numpy float64) fall through to the general path
    if isinstance(obj, bool):
        return bool(obj)
    if isinstance(obj, float):
        return _canon(float(obj))
    if isinstance(obj, int):
        return int(obj)
    if isinstance(obj, dict):
        return {k: _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    return obj


def canonical_json(row) -> str:
    """One canonical line: sorted keys, compact separators, rounded floats.
    Equal rows produce equal bytes on every platform."""
    return json.dumps(_canon(row), sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def rfloat(v):
    """Pre-round one value to the canonical float precision — the producer
    half of the :meth:`JsonlWriter.write_flat` contract.  Non-floats
    (ints, strings, ``None``) pass through."""
    return round(v, _NDIGITS) + 0.0 if isinstance(v, float) else v


class JsonlWriter:
    """Streaming canonical-JSONL writer with a running stream digest.

    ``path=None`` is a digest-only sink: rows are hashed and counted but
    written nowhere (used when only the Prometheus snapshot was requested —
    the report still records what *would* have been emitted).

    Lines are buffered and hashed/written in chunks: one ``sha256.update``
    per ~512 rows instead of per row (the digest over the concatenated
    stream is identical), which matters at ~10⁵ trace rows per campaign."""

    _CHUNK = 512

    def __init__(self, path: str | None):
        self.path = path
        self._f = open(path, "w") if path else None
        self.rows = 0
        self._hash = hashlib.sha256()
        self._buf: list[str] = []

    def write(self, row: dict) -> None:
        self._buf.append(canonical_json(row) + "\n")
        self.rows += 1
        if len(self._buf) >= self._CHUNK:
            self._flush()

    def write_flat(self, row: dict) -> None:
        """Fast path for rows the producer guarantees canonical already:
        flat primitives with floats pre-rounded via :func:`rfloat`.  Skips
        the :func:`_canon` pass — this runs once per trace row, and a full
        campaign streams ~10⁵ of them (``allow_nan=False`` still rejects
        non-finite floats at serialization time)."""
        self._buf.append(json.dumps(row, sort_keys=True,
                                    separators=(",", ":"),
                                    allow_nan=False) + "\n")
        self.rows += 1
        if len(self._buf) >= self._CHUNK:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        chunk = "".join(self._buf)
        self._buf.clear()
        self._hash.update(chunk.encode())
        if self._f is not None:
            self._f.write(chunk)

    def digest(self) -> str:
        """SHA-256 over every emitted line so far."""
        self._flush()
        return self._hash.hexdigest()

    def close(self) -> None:
        self._flush()
        if self._f is not None:
            self._f.close()
            self._f = None


# ------------------------------------------------------- prometheus text
def _fmt_value(v) -> str:
    """Canonical sample-value text: fixed rounding, shortest repr."""
    v = float(v)
    if not math.isfinite(v):
        raise ValueError(f"non-finite sample value: {v!r}")
    return repr(round(v, _NDIGITS) + 0.0)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: dict, extra: tuple = ()) -> str:
    items = sorted(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


def prometheus_text(registry) -> str:
    """Render a :class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot in the
    Prometheus text exposition format (families sorted by name, children by
    label values — deterministic byte-for-byte)."""
    out = []
    for fam in registry.collect():
        out.append(f"# HELP {fam.name} {fam.help}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for labels, child in fam.samples():
            lab = dict(labels)
            if fam.kind == "histogram":
                acc = 0
                for ub, c in zip(fam.buckets, child.bucket_counts):
                    acc += c
                    out.append(f"{fam.name}_bucket"
                               f"{_label_str(lab, (('le', repr(float(ub))),))}"
                               f" {acc}")
                out.append(f"{fam.name}_bucket"
                           f"{_label_str(lab, (('le', '+Inf'),))}"
                           f" {child.count}")
                out.append(f"{fam.name}_sum{_label_str(lab)} "
                           f"{_fmt_value(child.sum)}")
                out.append(f"{fam.name}_count{_label_str(lab)} {child.count}")
            else:
                out.append(f"{fam.name}{_label_str(lab)} "
                           f"{_fmt_value(child.value)}")
    return "\n".join(out) + "\n" if out else ""


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r" (?P<value>\S+)$")
_LABEL_PAIR_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def lint_prometheus(text: str) -> list[str]:
    """Format lint of a Prometheus text exposition; returns problems
    (empty = OK).  Checks line grammar, label syntax, value parseability,
    TYPE declarations, and histogram invariants (``+Inf`` bucket present,
    cumulative bucket monotonicity, ``_count`` == ``+Inf``)."""
    problems: list[str] = []
    typed: dict[str, str] = {}
    hist: dict[str, dict] = {}          # base name+labels -> bucket state
    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                problems.append(f"line {i}: malformed comment {line!r}")
            elif parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in _TYPES:
                    problems.append(f"line {i}: bad TYPE {line!r}")
                else:
                    typed[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {i}: unparseable sample {line!r}")
            continue
        name, labels, value = m.group("name", "labels", "value")
        try:
            float(value)
        except ValueError:
            problems.append(f"line {i}: bad value {value!r}")
        lab_items: list[tuple[str, str]] = []
        if labels:
            for pair in _split_labels(labels[1:-1]):
                if not _LABEL_PAIR_RE.match(pair):
                    problems.append(f"line {i}: bad label {pair!r}")
                else:
                    k, v = pair.split("=", 1)
                    lab_items.append((k, v[1:-1]))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in typed:
                base = name[:-len(suffix)]
                break
        if base not in typed:
            problems.append(f"line {i}: sample {name!r} has no # TYPE")
            continue
        if typed[base] == "histogram" and name == base + "_bucket":
            le = dict(lab_items).get("le")
            if le is None:
                problems.append(f"line {i}: _bucket without le label")
                continue
            key = (base, tuple(sorted(p for p in lab_items
                                      if p[0] != "le")))
            st = hist.setdefault(key, {"last": -1.0, "inf": None})
            c = float(value)
            if c < st["last"]:
                problems.append(f"line {i}: non-monotonic buckets for "
                                f"{base}")
            st["last"] = c
            if le == "+Inf":
                st["inf"] = c
        elif typed[base] == "histogram" and name == base + "_count":
            key = (base, tuple(sorted(lab_items)))
            st = hist.get(key)
            if st is None or st["inf"] is None:
                problems.append(f"line {i}: histogram {base} missing "
                                f"+Inf bucket before _count")
            elif float(value) != st["inf"]:
                problems.append(f"line {i}: {base}_count != +Inf bucket")
    return problems


def _split_labels(body: str) -> list[str]:
    """Split ``k1="v1",k2="v2"`` respecting escaped quotes."""
    parts, cur, in_str, esc = [], [], False, False
    for ch in body:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_str = not in_str
        elif ch == "," and not in_str:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def main(argv=None) -> int:
    """``python -m repro_torch.obs.export --lint FILE``: Prometheus format lint."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.export",
                                 description=main.__doc__)
    ap.add_argument("--lint", metavar="METRICS.prom", required=True,
                    help="validate a Prometheus text-format file and exit")
    args = ap.parse_args(argv)
    with open(args.lint) as f:
        problems = lint_prometheus(f.read())
    for p in problems:
        print(f"PROM: {p}", file=sys.stderr)
    print("prometheus format " + ("FAIL" if problems else "OK"),
          file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(main())
