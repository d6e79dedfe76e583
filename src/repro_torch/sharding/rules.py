"""Rule-based parameter, cache, batch and optimizer-state sharding with a
divisibility fallback: `repro/sharding/rules.py` over DTensor.

Logical axes:
  fsdp -> the data-parallel mesh axes (("pod","data") / ("data",)): FSDP
          weight sharding and ZeRO optimizer-state sharding.
  tp   -> the model axis: tensor and expert parallelism.

A dim whose size does not divide the mapped mesh axes is replicated instead
(e.g. 8 KV heads on a 16-way model axis).  Rules are keyed on (leaf name,
rank).  `repro` stacks a block's leaves over a leading repeat dim and
prepends None to the rule there; the port's blocks are an `nn.ModuleList`
of per-layer modules, so a rule applies at the leaf's own rank and a
layer's spec is `repro`'s stacked spec without its leading None.

A spec is a tuple with one entry a tensor dim, `tuple(PartitionSpec)` of
`repro`'s: None, an axis name, or a tuple of axis names (major to minor).
`placements` turns it into DTensor placements.  The functions read only the
mesh's axis names and sizes, so they take a `DeviceMesh` or an
`AbstractMesh` alike.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_sizes, dp_axes

# (name, rank) -> logical spec (per unstacked shape)
_PARAM_RULES: dict[tuple[str, int], tuple] = {
    ("embed", 2): ("tp", "fsdp"),
    ("lm_head", 2): ("fsdp", "tp"),
    ("scale", 1): (None,),
    # attention
    ("w_q", 2): ("fsdp", "tp"),
    ("w_k", 2): ("fsdp", "tp"),
    ("w_v", 2): ("fsdp", "tp"),
    ("w_o", 2): ("tp", "fsdp"),
    # MLA
    ("w_dkv", 2): ("fsdp", None),
    ("w_kr", 2): ("fsdp", None),
    ("w_uk", 2): ("fsdp", "tp"),
    ("w_uv", 2): ("fsdp", "tp"),
    # dense ffn
    ("w_gate", 2): ("fsdp", "tp"),
    ("w_up", 2): ("fsdp", "tp"),
    ("w_down", 2): ("tp", "fsdp"),
    # moe (experts over tp, fsdp within the expert)
    ("router", 2): ("fsdp", None),
    ("w_gate", 3): ("tp", "fsdp", None),
    ("w_up", 3): ("tp", "fsdp", None),
    ("w_down", 3): ("tp", "fsdp", None),
    # mamba
    ("in_proj", 2): ("fsdp", "tp"),
    ("conv_w", 2): (None, "tp"),
    ("conv_b", 1): ("tp",),
    ("x_proj", 2): ("tp", None),
    ("dt_proj", 2): (None, "tp"),
    ("dt_bias", 1): ("tp",),
    ("A_log", 2): ("tp", None),
    ("D", 1): ("tp",),
    ("out_proj", 2): ("tp", "fsdp"),
    # mlstm
    ("up_proj", 2): ("fsdp", "tp"),
    ("down_proj", 2): ("tp", "fsdp"),
    ("w_i", 2): ("fsdp", None),
    ("w_f", 2): ("fsdp", None),
    ("b_i", 1): (None,),
    ("b_f", 1): (None,),
    ("gn_scale", 1): ("tp",),
}

# decode-cache leaves: (name, rank) -> logical spec including the leading R dim
# seq-dim sharding is decided dynamically (see cache_sharding).
_CACHE_SEQ_LEAVES = {"k", "v", "ckv", "kr", "xk", "xv"}
_CACHE_RULES: dict[tuple[str, int], tuple] = {
    ("h", 4): (None, "dp", "tp", None),          # mamba state (R,B,di,N)
    ("conv", 4): (None, "dp", None, "tp"),       # conv buffer (R,B,dc-1,di)
    ("C", 5): (None, "dp", None, "tp", None),    # mlstm matrix (R,B,H,dh,dh)
    ("n", 4): (None, "dp", None, "tp"),
    ("m", 3): (None, "dp", None),
}


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def resolve_spec(mesh, logical: tuple, shape: tuple, *, fsdp_axes,
                 tp_axes) -> tuple:
    """Map a logical spec to a spec tuple with the divisibility fallback."""
    mapping = {"fsdp": fsdp_axes, "tp": tp_axes, "dp": fsdp_axes}
    out = []
    used: set = set()
    for dim, logi in zip(shape, logical):
        axes = mapping.get(logi) if logi else None
        if axes is None:
            out.append(None)
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        axes_t = tuple(a for a in axes_t if a not in used)
        if not axes_t or dim % _axes_size(mesh, axes_t) != 0:
            out.append(None)
            continue
        used.update(axes_t)
        out.append(axes_t[0] if len(axes_t) == 1 else axes_t)
    return tuple(out)


def placements(mesh, spec: tuple) -> list:
    """DTensor placements of a spec: for each mesh dim in mesh order,
    Shard(d) where tensor dim d is split over it, else Replicate().  A dim
    over ("pod", "data") is Shard(d) on both, outer first, as JAX splits
    a dim major to minor; a spec that names them in another order
    raises.  A mesh dim of size 1 is Replicate() whatever the spec says
    (a split in one part is none, and DTensor would refuse views of it)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order "
                             f"{names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def spec_of(t) -> tuple:
    """The spec tuple of a DTensor's placements (mesh axes per tensor
    dim, major to minor); the inverse of `placements`."""
    names = tuple(t.device_mesh.mesh_dim_names)
    spec = [None] * t.ndim
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            prev = spec[p.dim]
            spec[p.dim] = name if prev is None else (
                ((prev,) if isinstance(prev, str) else prev) + (name,))
        elif not isinstance(p, Replicate):
            raise ValueError(f"{t.placements}: not a Shard/Replicate layout")
    return tuple(spec)


def _leaf_rule(name: str, ndim: int):
    return _PARAM_RULES.get((name.rsplit(".", 1)[-1], ndim))


def param_sharding(mesh, model, *, mode: str = "train") -> dict:
    """{parameter name: spec} over `model.named_parameters()` (or a mapping
    of names to tensors or shapes).  mode: 'train' (FSDP x TP), 'serve' (TP
    only, weights replicated over the data axes so that decode gathers no
    weight) or 'serve_big' (FSDP x TP, for models that cannot replicate)."""
    fsdp = dp_axes(mesh) if mode in ("train", "serve_big") else ()
    items = (model.items() if isinstance(model, dict)
             else model.named_parameters())
    out = {}
    for name, leaf in items:
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
        rule = _leaf_rule(name, len(shape))
        out[name] = ((None,) * len(shape) if rule is None else
                     resolve_spec(mesh, rule, shape, fsdp_axes=fsdp or None,
                                  tp_axes=("model",)))
    return out


def _dp_spec(mesh):
    dp = dp_axes(mesh)
    return dp, (dp[0] if len(dp) == 1 else dp)


def batch_sharding(mesh, batch: dict) -> dict:
    """Data inputs: the batch dim over (pod, data) where it divides."""
    dp, dp_spec = _dp_spec(mesh)

    def leaf(x):
        nd = len(x.shape)
        if nd == 0:
            return ()
        if x.shape[0] % _axes_size(mesh, dp) == 0:
            return (dp_spec,) + (None,) * (nd - 1)
        return (None,) * nd

    return {k: leaf(v) for k, v in batch.items()}


def cache_sharding(mesh, cache):
    """Decode-cache specs, in the cache's own structure (a tuple over
    pattern positions of {name: tensor}).  KV-type leaves (R,B,S,...): batch
    over dp when divisible; when the batch cannot shard (e.g. long_500k
    B=1) the sequence dim shards over dp instead.  The KV-head dim goes over
    `model`; where the heads do not divide it (GQA with few KV heads) the
    sequence dim shards over `model` instead.  (`repro`'s `seq_shard_axis`
    argument, unused there, is left out.)"""
    dp, dp_spec = _dp_spec(mesh)
    dp_size = _axes_size(mesh, dp)
    tp_size = axis_sizes(mesh).get("model", 1)

    def leaf(name, x):
        shape = tuple(x.shape)
        nd = len(shape)
        if (name, nd) in _CACHE_RULES:
            return resolve_spec(mesh, _CACHE_RULES[(name, nd)], shape,
                                fsdp_axes=dp, tp_axes=("model",))
        if name in _CACHE_SEQ_LEAVES:
            B, S = shape[1], shape[2]
            parts = [None] * nd
            if B % dp_size == 0:
                parts[1] = dp_spec
            elif S % dp_size == 0:
                parts[2] = dp_spec
            if nd >= 4 and shape[3] % tp_size == 0 and tp_size > 1:
                parts[3] = "model"
            elif parts[2] is None and S % tp_size == 0 and tp_size > 1:
                parts[2] = "model"
            return tuple(parts)
        return (None,) * nd

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        return leaf(name, tree)

    return walk(cache)


def opt_state_sharding(mesh, params_sharding: dict, opt_state: dict) -> dict:
    """Specs of AdamW's state: each moment list entry takes its parameter's
    spec (the lists run in `named_parameters()` order, as `params_sharding`
    does); scalars are replicated."""
    specs = list(params_sharding.values())

    def walk(x):
        if isinstance(x, (list, tuple)):
            if len(x) != len(specs):
                raise ValueError(f"{len(x)} moments for {len(specs)} "
                                 "parameters")
            return [s if len(t.shape) else () for s, t in zip(specs, x)]
        return (None,) * len(x.shape)

    return {k: walk(v) for k, v in opt_state.items()}


def spec_bytes(shape, dtype, spec: tuple, mesh) -> int:
    """Bytes one device holds of a tensor of `shape` and `dtype` under
    `spec`."""
    n = 1
    for dim, axes in zip(shape, spec):
        n *= dim // _axes_size(mesh, axes)
    return n * torch.empty((), dtype=dtype).element_size()


def distribute(tensor: torch.Tensor, mesh, spec: tuple, *,
               src_data_rank: int | None = 0):
    """`tensor` as a DTensor on `mesh` under `spec`.  Every rank passes the
    whole tensor; rank `src_data_rank` sends its values (None: each rank
    keeps its own slice, with no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tensor, mesh, placements(mesh, spec),
                             src_data_rank=src_data_rank)


def distribute_tree(tree, mesh, specs, *, src_data_rank: int | None = 0):
    """Each tensor leaf of `tree` (nested dicts, lists and tuples) as a
    DTensor under the spec in its place in `specs`, a tree of the same
    structure (`cache_sharding`, `opt_state_sharding`)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, specs[k],
                                   src_data_rank=src_data_rank)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, mesh, s,
                                          src_data_rank=src_data_rank)
                          for v, s in zip(tree, specs))
    return distribute(tree, mesh, specs, src_data_rank=src_data_rank)


def distribute_params(model, mesh, specs: dict, *,
                      src_data_rank: int | None = 0):
    """Replace each parameter of `model` by a DTensor parameter under its
    spec (in place; the module is returned)."""
    from torch import nn
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = distribute(p.detach(), mesh, specs[name],
                       src_data_rank=src_data_rank)
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return model
