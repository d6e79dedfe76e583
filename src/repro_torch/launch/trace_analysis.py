"""Per-device FLOPs, bytes and collective traffic of an eager PyTorch step,
read from the ops each rank executes: the port's counterpart of `repro`'s
`launch/hlo_analysis.py`, which parsed compiled HLO.  Torch has no HLO, so
`TraceMode` (a `TorchDispatchMode`) records the ops as they run:

  * it sees each rank's *local* ops: an op on DTensors is left to DTensor
    (`NotImplemented`), whose local op on the rank's shard and whose
    collectives then reach the mode as plain tensors (the global-shape
    ops DTensor runs under its own FakeTensorMode to infer shapes are
    not counted).  So the counts are
    per device; `FlopCounterMode` over DTensors counts the global op (a
    (256, 4096) @ (4096, 4096) sharded 16 x 16 counts 2*256*4096**2);
  * flops: matmul, bmm and convolution by `torch.utils.flop_counter`'s
    formulas, and the port's three kernels by the formulas that
    `kernels.ops` registers (the query-key pairs they visit; ROADMAP.md
    F14);
  * elementwise_flops: one flop per output element of every other op that
    computes (views, allocations and copies compute nothing);
  * bytes_accessed: operands plus outputs of every op that computes or
    copies.  Eager PyTorch does not fuse, so this is the port's own
    traffic, every intermediate written and read back, where `repro`
    charged XLA's fusion boundaries (ROADMAP.md F13);
  * collectives: per-device link bytes with hlo_analysis.py:15-19's ring
    factors (all-reduce 2(n-1)/n B, all-gather (n-1)/n B_result,
    reduce-scatter (n-1) B_result, all-to-all (n-1)/n B), n the group's
    size, for each `_c10d_functional` op and DTensor's shard-dim
    all-to-all;
  * memory: the bytes of the storages the step allocates that are alive
    at once (`peak_temp_bytes`), each counted until its last tensor dies.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# ops that move no data and compute nothing: views and allocations
_FREE = {
    "view", "_unsafe_view", "reshape", "alias", "as_strided", "t",
    "transpose", "permute", "expand", "select", "slice", "unsqueeze",
    "squeeze", "detach", "unbind", "split", "split_with_sizes", "chunk",
    "narrow", "diagonal", "unflatten", "view_as_real", "view_as_complex",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "lift_fresh", "_to_copy_meta", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "_local_scalar_dense", "wait_tensor", "_has_same_storage_numel",
}
# ops that copy without computing: their bytes count, their flops do not
_COPIES = {"copy_", "clone", "_to_copy", "contiguous", "cat", "stack",
           "index_select", "gather", "index", "_unsafe_index", "roll",
           "constant_pad_nd", "new_zeros", "zeros", "zeros_like", "ones",
           "ones_like", "full", "full_like", "fill_", "zero_", "new_full",
           "arange", "repeat", "repeat_interleave", "flip", "scalar_tensor"}

# link bytes per byte of the result, n the group size
_RING = {
    "all_reduce": lambda n: 2.0 * (n - 1) / n,
    "all_gather_into_tensor": lambda n: (n - 1) / n,
    "reduce_scatter_tensor": lambda n: float(n - 1),
    "all_to_all_single": lambda n: (n - 1) / n,
    "shard_dim_alltoall": lambda n: (n - 1) / n,
    "broadcast": lambda n: 1.0,
}
# `repro`'s HLO names, by which the breakdown is keyed
_HLO_NAME = {"all_reduce": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "shard_dim_alltoall": "all-to-all",
             "broadcast": "collective-permute"}


@dataclasses.dataclass
class TraceStats:
    flops: float = 0.0              # per-device matmul (+conv, kernel) flops
    elementwise_flops: float = 0.0
    bytes_accessed: float = 0.0     # per-device memory traffic, op by op
    collective_bytes: float = 0.0   # per-device link bytes (ring model)
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    collective_count: int = 0
    collective_largest: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    peak_temp_bytes: int = 0        # allocations alive at once, at most

    def scaled(self, k: float) -> "TraceStats":
        """These counts k times over (a step repeated k times)."""
        return dataclasses.replace(
            self, flops=self.flops * k,
            elementwise_flops=self.elementwise_flops * k,
            bytes_accessed=self.bytes_accessed * k,
            collective_bytes=self.collective_bytes * k,
            collective_breakdown={a: b * k for a, b in
                                  self.collective_breakdown.items()},
            collective_count=int(self.collective_count * k),
            ops=int(self.ops * k))

    def plus(self, o: "TraceStats") -> "TraceStats":
        br = dict(self.collective_breakdown)
        for a, b in o.collective_breakdown.items():
            br[a] = br.get(a, 0.0) + b
        big = dict(self.collective_largest)
        for a, b in o.collective_largest.items():
            big[a] = max(big.get(a, 0), b)
        return TraceStats(
            self.flops + o.flops, self.elementwise_flops + o.elementwise_flops,
            self.bytes_accessed + o.bytes_accessed,
            self.collective_bytes + o.collective_bytes, br,
            self.collective_count + o.collective_count, big,
            self.ops + o.ops, max(self.peak_temp_bytes, o.peak_temp_bytes))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def group_size(name) -> int:
    """The size of a process group given by its name (or the group)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    g = _resolve_process_group(name) if isinstance(name, str) else name
    return g.size()


class TraceMode(TorchDispatchMode):
    """Records the ops each rank runs on its local tensors (see the
    module's docstring); `stats` holds the counts."""

    def __init__(self):
        super().__init__()
        self.stats = TraceStats()
        self._live: dict = {}            # storage key -> [tensors alive, bytes]
        self._temp = 0

    @classmethod
    def ignore_compile_internals(cls) -> bool:
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        # DTensor infers an op's global output shape by running it once on
        # fake tensors of the global shape: no device runs that
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        st = self.stats
        name = func._overloadpacket.__name__
        ns = func.namespace
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        flat_out = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
        self._track(flat_in, flat_out)
        if name in _FREE:
            return
        st.ops += 1
        out_b = sum(_nbytes(o) for o in flat_out)
        if ns in ("_c10d_functional", "_c10d_functional_autograd",
                  "_dtensor") and name in _RING:
            n = group_size(args[-1] if name == "shard_dim_alltoall"
                           else _group_arg(func, args, kwargs))
            link = _RING[name](n) * out_b
            key = _HLO_NAME[name]
            st.collective_bytes += link
            st.collective_breakdown[key] = \
                st.collective_breakdown.get(key, 0.0) + link
            st.collective_largest[key] = max(
                st.collective_largest.get(key, 0), out_b)
            st.collective_count += 1
            st.bytes_accessed += out_b
            return
        st.bytes_accessed += out_b + sum(_nbytes(a) for a in flat_in)
        packet = func._overloadpacket
        if packet in flop_registry:
            st.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif name not in _COPIES:
            st.elementwise_flops += sum(o.numel() for o in flat_out)

    def _track(self, flat_in, flat_out) -> None:
        """Count each new storage's bytes while a tensor of it lives."""
        arg_keys = {_storage_key(a) for a in flat_in}
        for o in flat_out:
            key = _storage_key(o)
            if key is None:
                continue
            entry = self._live.get(key)
            if entry is None:
                if key in arg_keys:        # in place or a view of an input
                    continue               # the trace did not allocate
                entry = self._live[key] = [0, o.untyped_storage().nbytes()]
                self._temp += entry[1]
                self.stats.peak_temp_bytes = max(self.stats.peak_temp_bytes,
                                                 self._temp)
            entry[0] += 1
            weakref.finalize(o, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self._temp -= entry[1]
            del self._live[key]


def _group_arg(func, args, kwargs):
    """The group name argument of a functional collective."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_name":
            return kwargs.get("group_name", args[i] if i < len(args) else None)
    raise ValueError(f"{func}: no group_name argument")


_ACTIVE: list = []


def active() -> TraceMode | None:
    """The innermost `trace`'s mode, or None outside one."""
    return _ACTIVE[-1] if _ACTIVE else None


def trace(fn, *args, **kwargs):
    """(fn(*args, **kwargs), TraceStats of the ops it ran on this rank)."""
    mode = TraceMode()
    _ACTIVE.append(mode)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return out, mode.stats


def repeat_counts(mode: TraceMode, fn, times: float):
    """fn() under `mode`, its counts (flops, bytes, ops) added `times`
    times in all: for work that repeats alike, traced once."""
    st = mode.stats
    before = (st.flops, st.elementwise_flops, st.bytes_accessed, st.ops)
    out = fn()
    extra = times - 1
    st.flops += (st.flops - before[0]) * extra
    st.elementwise_flops += (st.elementwise_flops - before[1]) * extra
    st.bytes_accessed += (st.bytes_accessed - before[2]) * extra
    st.ops += int((st.ops - before[3]) * extra)
    return out


def local_bytes(tree) -> int:
    """Bytes this rank holds of the tensors in `tree` (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total
