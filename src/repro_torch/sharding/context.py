"""Activation-sharding context: `repro/sharding/context.py`'s logical
`with_sharding_constraint` over DTensor.

Model code calls `constrain(x, "dp", None, "tp")` with *logical* axes; the
launcher installs the mesh with `activation_mesh(mesh)`.  Without a mesh, on
a mesh of one device, or on a plain tensor (a rank's own shard inside the
local routes of the kernels, the MoE and the output projections), a
constraint is a no-op, so layer code stays mesh-agnostic.  Dims that do not divide their mapped axes are replicated,
the parameters' policy.  Where GSPMD took the constraint as a layout to
reach, `constrain` redistributes the DTensor to it: a Partial sum becomes a
reduce-scatter or an all-reduce, a replicated dim a local slice.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.distributed.tensor import DTensor, Shard

from .rules import placements

_MESH = None


def _plain_costs():
    """(torch's cost module, the plain price).  DTensor prices each
    candidate strategy of an op by the collectives that would reach it; a
    candidate over `_StridedShard` (a view of a sharded dim) or a
    non-default shard order is priced by a search over every placement of
    every mesh dim, some 16 ms each, thousands of them on a model's first
    step.  The plain price of those is a gather of the whole tensor (its
    bytes, in GB, twice: a bound on any move) unless no move is needed;
    every other pair keeps torch's price, and the redistributions that run
    are planned and carried out as before.  It reads torch's private names
    and raises RuntimeError, naming the torch version, where one is
    missing."""
    try:
        from torch.distributed.tensor import _ops
        from torch.distributed.tensor._dtensor_spec import DTensorSpec
        from torch.distributed.tensor.placement_types import _StridedShard
        utils = _ops.utils
        full = utils.redistribute_cost
        for name in ("shard_order", "is_default_device_order"):
            if not hasattr(DTensorSpec, name):
                raise AttributeError(f"DTensorSpec.{name}")
    except (ImportError, AttributeError) as e:
        raise RuntimeError(
            f"torch {torch.__version__} lacks a private name that "
            f"activation_mesh's DTensor pricing reads: {e}") from e
    full = getattr(full, "_repro_full", full)

    def odd(spec) -> bool:
        return any(isinstance(p, _StridedShard) for p in spec.placements) \
            or not spec.is_default_device_order(spec.shard_order)

    def cost(current, target):
        if odd(current) or odd(target):
            same = (current.placements == target.placements
                    and current.shard_order == target.shard_order)
            if same or current.is_replicated():
                return 0.0
            meta = current.tensor_meta
            item = torch.empty((), dtype=meta.dtype).element_size()
            return 2.0 * math.prod(meta.shape) * item / 2**30
        return full(current, target)

    cost._repro_full = full
    return utils, cost


@contextlib.contextmanager
def activation_mesh(mesh):
    """Install `mesh` for `constrain`.  Plain tensors that meet DTensors
    inside (masks, positions, rotary tables: GSPMD's replicated constants)
    are taken as replicated.  Inside, DTensor prices strided candidates by
    `_plain_costs`; torch's own price is back on exit."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _MESH
    utils, cost = _plain_costs()
    prev, prev_cost = _MESH, utils.redistribute_cost
    _MESH = mesh
    utils.redistribute_cost = cost
    try:
        with implicit_replication():
            yield
    finally:
        _MESH = prev
        utils.redistribute_cost = prev_cost


def current_mesh():
    return _MESH


def resolve(mesh, logical, shape) -> tuple:
    """The spec tuple of a logical activation spec on `mesh`, with
    `repro`'s fallback: a dim its axes do not divide is replicated
    (`repro`'s `_resolve`)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    dp = tuple(a for a in ("pod", "data") if a in names)
    mapping = {"dp": dp, "tp": ("model",) if "model" in names else ()}
    out = []
    used: set = set()
    for dim, logi in zip(shape, logical):
        axes = mapping.get(logi, ()) if logi else ()
        axes = tuple(a for a in axes if a not in used)
        size = math.prod(sizes[a] for a in axes) if axes else 1
        if not axes or size == 1 or dim % size != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    """Apply a logical activation-sharding constraint (no-op without a
    mesh, on a one-device mesh, or on a plain tensor)."""
    if _MESH is None or _MESH.size() == 1 or not isinstance(x, DTensor):
        return x
    assert len(logical) == x.ndim, (logical, x.shape)
    want = placements(_MESH, resolve(_MESH, logical, x.shape))
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(_MESH, want)


def to_layout(t: torch.Tensor, mesh, spec: tuple):
    """t (a DTensor, or a plain tensor taken as replicated) in the layout
    of `spec` (a spec tuple of `sharding.rules`)."""
    from torch.distributed.tensor import Replicate
    want = tuple(placements(mesh, spec))
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t


def from_shard(local: torch.Tensor, mesh, placements_, shape) -> DTensor:
    """A DTensor of global `shape` (contiguous) from this rank's shard."""
    shape = tuple(shape)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local.contiguous(), mesh, placements_,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def axis_index(mesh, names) -> int:
    """This rank's index over the mesh axes `names` (major to minor)."""
    if isinstance(names, str):
        names = (names,)
    idx = 0
    for a in names:
        idx = idx * mesh.shape[mesh.mesh_dim_names.index(a)] \
            + mesh.get_local_rank(a)
    return idx


def batch_local(fn, *args):
    """fn(*args) on each rank's batch rows: every DTensor (or plain tensor,
    taken as replicated) in args, nested in tuples, is laid out with its
    dim 0 over the data axes (where it divides) and all else whole, fn runs
    on the local shards, and its tensor outputs (nested in tuples) come
    back as DTensors split the same way.  Each rank computes its rows in
    full, so the gradients are those of its rows."""
    mesh = _MESH
    spec0 = None

    def local(t):
        nonlocal spec0
        if isinstance(t, tuple):
            return tuple(local(u) for u in t)
        if not isinstance(t, torch.Tensor):
            return t
        spec = resolve(mesh, ("dp",) + (None,) * (t.ndim - 1), t.shape)
        spec0 = spec0 or spec
        return to_layout(t, mesh, spec).to_local()

    out = fn(*local(args))
    place = placements(mesh, spec0[:1])

    def wrap(t):
        if isinstance(t, tuple):
            return tuple(wrap(u) for u in t)
        split = math.prod(n for p, n in zip(place, mesh.shape)
                          if isinstance(p, Shard))
        return from_shard(t, mesh, place,
                          (t.shape[0] * split,) + tuple(t.shape[1:]))

    return wrap(out)
