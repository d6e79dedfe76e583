"""Signed run manifests: artifact sha256s + config provenance, HMAC-sealed.

A durable run refreshes ``manifest.json`` at every snapshot and again at
finalize, so the manifest is always present for ``--resume`` to verify
*before* unpickling any snapshot — pickles are only loaded after their
recorded sha256 matches the file bytes and the manifest's HMAC-SHA256
signature verifies.  The signing key comes from ``REPRO_MANIFEST_KEY``;
without it a documented development key is used (tamper-*evidence* for CI
and local runs, not secrecy — anyone holding the key can re-sign).

The manifest body contains no wall-clock timestamps, so for a fixed
scenario/seed the finalized manifest is byte-identical across runs — the
same discipline every other deterministic artifact in this repo follows.

Copied from `repro/durability/manifest.py`.  ``KEY_ENV`` and ``DEV_KEY``
are `repro`'s, verbatim, so either package verifies a manifest the other
signed with the same key.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import os

MANIFEST_SCHEMA = "repro.durability.manifest/v1"
DEV_KEY = "repro-dev-manifest-key"      # documented fallback, not a secret
KEY_ENV = "REPRO_MANIFEST_KEY"


def _key() -> bytes:
    return os.environ.get(KEY_ENV, DEV_KEY).encode()


def _canonical(body: dict) -> bytes:
    return json.dumps(body, sort_keys=True, separators=(",", ":"),
                      allow_nan=False).encode()


def file_sha256(path: str) -> tuple[str, int]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


def sign_manifest(body: dict) -> str:
    body = {k: v for k, v in body.items() if k != "signature"}
    return hmac.new(_key(), _canonical(body), hashlib.sha256).hexdigest()


def build_manifest(rundir: str, artifacts: list[str], run_meta: dict) -> dict:
    """List every artifact (paths inside ``rundir`` become relative) with
    its sha256 + byte length, attach provenance, and sign."""
    rundir = os.path.abspath(rundir)
    entries: dict[str, dict] = {}
    for path in sorted(set(artifacts)):
        apath = os.path.abspath(path)
        if not os.path.exists(apath):
            continue
        rel = (os.path.relpath(apath, rundir)
               if apath.startswith(rundir + os.sep) else apath)
        sha, size = file_sha256(apath)
        entries[rel] = {"sha256": sha, "bytes": size}
    body = {"schema": MANIFEST_SCHEMA, "run": run_meta,
            "artifacts": entries}
    return {**body, "signature": sign_manifest(body)}


def write_manifest(path: str, manifest: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def verify_manifest(path: str, check_files: bool = True) -> list[str]:
    """Return human-readable problems (empty list == signature and every
    recorded artifact hash verify)."""
    problems: list[str] = []
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable manifest {path}: {e}"]
    sig = manifest.pop("signature", None)
    if sig is None:
        return [f"manifest {path} has no signature"]
    want = sign_manifest(manifest)
    if not hmac.compare_digest(sig, want):
        problems.append("HMAC signature mismatch (wrong key or tampered "
                        "manifest)")
    if not check_files:
        return problems
    rundir = os.path.dirname(os.path.abspath(path))
    for rel, entry in manifest.get("artifacts", {}).items():
        apath = rel if os.path.isabs(rel) else os.path.join(rundir, rel)
        if not os.path.exists(apath):
            problems.append(f"artifact missing: {rel}")
            continue
        sha, size = file_sha256(apath)
        if sha != entry["sha256"]:
            problems.append(f"artifact sha256 mismatch: {rel}")
        elif size != entry["bytes"]:
            problems.append(f"artifact length mismatch: {rel}")
    return problems
