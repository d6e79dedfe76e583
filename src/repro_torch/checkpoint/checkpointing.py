"""Atomic, async-capable checkpoints of trees of tensors, copied from
`repro/checkpoint/checkpointing.py`: the same directory layout and manifest
format.  The two packages' train-state trees differ, though: the port keeps
per-layer leaves in module order, `repro` stacks its `blocks` and sorts dict
keys, so neither package can resume the other's run.

Layout: <dir>/step_<N>/ with one `leaves.npz` (leaf_0, leaf_1, ... in tree
order) and a JSON manifest (tree structure, shapes, dtypes, step).  Writes go
to a temp dir and an atomic rename, so a SIGTERM mid-write never corrupts the
latest checkpoint: the persistence behind MuxFlow's graceful-exit and
evict/restart paths.  A tree is nested dicts (keys in sorted order, as JAX
flattens them), lists and tuples with tensors at the leaves.  numpy has no
bfloat16: a bf16 leaf is stored as its uint16 bit pattern and recorded as
"bfloat16" in the manifest.

Over a mesh a leaf may be a DTensor: `save` writes its full value, once,
from rank 0 (every rank takes part in gathering it), so the format stays
the single-device one, and `restore(..., shardings=)` reads every leaf
whole and distributes it by the specs given: a checkpoint written on one
mesh restores onto another.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from repro_torch import resolve_device


def _flatten(tree) -> tuple[list, object]:
    """(leaves in order, structure), the structure a nest of dicts, lists
    and tuples with None where a leaf was."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([l for p in parts for l in p[0]],
                {k: p[1] for k, p in zip(keys, parts)})
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        return ([l for p in parts for l in p[0]],
                type(tree)(p[1] for p in parts))
    return [tree], None


def _unflatten(struct, leaves):
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(build(v) for v in s)
        return next(it)

    return build(struct)


def _full(leaf):
    """A DTensor's full value (a collective: every rank calls it); any
    other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of an initialised
    process group, or a process with none."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    t = _full(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        leaves, struct = _flatten(tree)
        arrays, dtypes = {}, []
        for i, leaf in enumerate(leaves):
            arrays[f"leaf_{i}"], dtype = _to_numpy(leaf)
            dtypes.append(dtype)
        manifest = {"step": step, "treedef": repr(struct),
                    "n_leaves": len(leaves),
                    "shapes": [list(l.shape) for l in leaves],
                    "dtypes": dtypes}
        np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                   # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and
             os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like_tree, *, step: int | None = None,
            device=None, shardings=None):
    """(tree, step): the checkpoint at `step` (the latest by default) in
    the structure of `like_tree`, its leaves on `device` (the CUDA card
    unless `device="cpu"` is passed).  Raises ValueError unless every leaf
    has the shape and dtype of `like_tree`'s leaf in its place (a DTensor
    leaf's global shape).  With `shardings`, a tree of spec tuples
    (`sharding.rules`) in like_tree's structure, each leaf read whole is
    then distributed by its spec on the mesh that `activation_mesh`
    installed (ValueError without one): every rank reads the same file, so
    no values travel."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, struct = _flatten(like_tree)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"tree structure changed: {len(leaves)} leaves, "
                         f"the checkpoint has {manifest['n_leaves']}")
    # a leaf of another shape would broadcast into the live weight it is
    # copied to, so every leaf must match like_tree's exactly
    for i, (leaf, shape, dtype) in enumerate(zip(
            leaves, manifest["shapes"], manifest["dtypes"])):
        want = (list(leaf.shape), str(leaf.dtype).removeprefix("torch."))
        if (shape, dtype) != want:
            raise ValueError(f"leaf {i}: the checkpoint holds {dtype} "
                             f"{shape}, the tree expects {want[1]} {want[0]}")
    out = []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for i, dtype in enumerate(manifest["dtypes"]):
            arr = data[f"leaf_{i}"]
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if dtype == "bfloat16" else torch.from_numpy(arr))
            out.append(t.to(dev))
    if shardings is not None:
        from repro_torch.sharding.context import current_mesh
        from repro_torch.sharding.rules import distribute
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("restoring with shardings needs a mesh: "
                             "install one with activation_mesh")
        specs, _ = _flatten_specs(shardings)
        if len(specs) != len(out):
            raise ValueError(f"{len(specs)} shardings for {len(out)} leaves")
        out = [t if s is None else distribute(t, mesh, s, src_data_rank=None)
               for t, s in zip(out, specs)]
    return _unflatten(struct, out), step


def _is_spec(x) -> bool:
    """A spec tuple: each entry None, an axis name or a tuple of names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and e and all(isinstance(a, str) for a in e))
        for e in x)


def _flatten_specs(tree) -> tuple[list, None]:
    """`_flatten`'s order over a tree whose leaves are spec tuples (or
    None)."""
    if tree is None or _is_spec(tree):
        return [tree], None
    items = ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
             else list(tree))
    return [l for t in items for l in _flatten_specs(t)[0]], None


class AsyncCheckpointer:
    """Background-thread checkpointing: the train loop hands off host copies
    and keeps stepping (the paper hides scheduling/checkpoint overhead inside
    the interval the same way)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None

    def save(self, step: int, tree) -> None:
        """Hand a host copy of `tree` to the writer thread.  DTensor leaves
        are gathered first, on every rank; only rank 0 writes."""
        leaves, struct = _flatten(tree)
        host = _unflatten(struct, [_full(l).detach().to("cpu", copy=True)
                                   for l in leaves])
        if not _writer():
            return
        self.wait()
        self._thread = threading.Thread(
            target=self._do_save, args=(step, host), daemon=True)
        self._thread.start()

    def _do_save(self, step, host_tree):
        save(self.ckpt_dir, step, host_tree, keep=self.keep)
        self.last_saved = step

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
