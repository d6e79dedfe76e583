"""Mixture-of-Experts FFN with top-k routing and optional shared experts.

Port of `repro/models/moe.py`, with its two execution paths:
  * `moe_dense_dispatch`, the plain oracle: every expert runs on every
    token and the results are combined with the (sparse) routing weights;
  * `moe_grouped_dispatch`, the production path: each batch row is a
    dispatch group whose slots go to per-expert buffers of capacity
    C = round(ceil(K*S/E) * capacity_factor); the experts run only on their
    buffers, and slots past an expert's capacity are dropped.

and its third, `moe_a2a_dispatch`, the expert-parallel dispatch over a
mesh's model axis with two all-to-alls (which falls back to the grouped
dispatch where `repro`'s does).

The expert products are `torch.einsum` (batched matmuls), as `repro`
computed them outside any Pallas kernel.  Over a mesh (DTensor inputs) the
grouped dispatch takes a local route (`_grouped_sharded`): DTensor has no
sharding rule for its argsort, searchsorted and scatter-add, so each rank
dispatches its own batch rows (exact: a group is one batch row), runs its
own experts and leaves their sum to an all-reduce over `model`, the
partial-sum combine GSPMD emits for `repro`'s grouped dispatch.

Weights keep `repro`'s layout: the router (d, E) in fp32, the experts
(E, d, f) and (E, f, d), so that `init_params` reads the leading dim as the
fan-in as `repro`'s `dense_init` does (the experts drawn with std 1/sqrt(E)).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.context import constrain, current_mesh

from . import layers as L


class MoE(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        self.router = L.param((d, E), torch.float32, device)
        self.w_gate = L.param((E, d, f), cfg.dtype, device)
        self.w_up = L.param((E, d, f), cfg.dtype, device)
        self.w_down = L.param((E, f, d), cfg.dtype, device)
        if cfg.num_shared_experts > 0:
            self.shared = L.FFN(d, f * cfg.num_shared_experts, cfg.dtype,
                                device)


def router_probs(moe: MoE, x: torch.Tensor, cfg):
    """Top-k routing.  x: (B,S,d) -> (weights (B,S,K) fp32, idx (B,S,K),
    the Switch-style load-balancing aux loss, an fp32 scalar).

    `torch.topk` gives the K largest probabilities in descending order, as
    `jax.lax.top_k` does; the two may order exact ties differently, which
    random weights do not produce (no tie is broken here on purpose)."""
    logits = x.float() @ moe.router                              # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.moe_renormalize:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
    E = cfg.num_experts
    me = probs.mean(dim=(0, 1))                        # mean prob per expert
    hit = F.one_hot(idx, E).sum(-2) > 0                # (B,S,E): routed to e
    ce = hit.float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return weights, idx, aux


def moe_dense_dispatch(moe: MoE, x: torch.Tensor, cfg):
    """The oracle: all E experts on all tokens, combined by the routing
    weights.  Returns (y (B,S,d) in x.dtype, aux)."""
    B, S, d = x.shape
    E, T = cfg.num_experts, B * S
    weights, idx, aux = router_probs(moe, x, cfg)
    xe = x.reshape(T, 1, d).expand(T, E, d)
    g = L.ACTS[cfg.ffn_act](torch.einsum("ted,edf->tef", xe, moe.w_gate))
    u = torch.einsum("ted,edf->tef", xe, moe.w_up)
    ye = torch.einsum("tef,efd->ted", g * u, moe.w_down)         # (T,E,d)
    rows = torch.arange(T, device=x.device)[:, None].expand(T, cfg.top_k)
    comb = torch.zeros((T, E), dtype=x.dtype, device=x.device).index_put(
        (rows, idx.reshape(T, -1)), weights.reshape(T, -1).to(x.dtype),
        accumulate=True)
    y = torch.einsum("ted,te->td", ye, comb).reshape(B, S, d)
    if hasattr(moe, "shared"):
        y = y + L.ffn(moe.shared, x, cfg.ffn_act)
    return y, aux


def capacity(S: int, cfg, capacity_factor: float) -> int:
    """Slots per expert in one group of S tokens: `repro`'s
    int(max(1, round(ceil(S*K/E) * cf))), at most S*K.  Python's `round`
    rounds half to even (S 8, K 2, E 8, cf 1.25: round(2.5) = 2)."""
    K, E = cfg.top_k, cfg.num_experts
    cap = int(max(1, round(-(-S * K // E) * capacity_factor)))
    return min(cap, S * K)


def slot_positions(e_ids: torch.Tensor, E: int) -> torch.Tensor:
    """e_ids: (B, M) expert of each slot, in (token, k) order.  Returns each
    slot's position among its group's slots for the same expert, earlier
    slots first: its rank in a stable argsort of the ids less the first
    rank of its expert (`repro`'s O(M log M) form)."""
    B, M = e_ids.shape
    order = torch.argsort(e_ids, dim=1, stable=True)
    arange = torch.arange(M, device=e_ids.device).expand(B, M)
    ranks = torch.empty_like(order).scatter_(1, order, arange)
    sorted_e = torch.gather(e_ids, 1, order)
    experts = torch.arange(E, device=e_ids.device).expand(B, E).contiguous()
    start = torch.searchsorted(sorted_e.contiguous(), experts, side="left")
    return ranks - torch.gather(start, 1, e_ids)


def moe_grouped_dispatch(moe: MoE, x: torch.Tensor, cfg,
                         capacity_factor: float = 1.25):
    """Capacity-based grouped dispatch, one group a batch row.  Returns
    (y (B,S,d) in x.dtype, aux).

    Every slot is scattered into its expert's buffer at its position; a slot
    past the capacity is sent to row cap - 1 with a zero value, and the
    values are *added* there as `repro` adds them, so the kept slot in that
    row is not overwritten.  At decode (S 1) the capacity is 1 and no slot
    is dropped, so a row's result does not depend on the other rows."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _grouped_sharded(moe, x, cfg, capacity_factor)
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    M = S * K
    weights, idx, aux = router_probs(moe, x, cfg)
    cap = capacity(S, cfg, capacity_factor)
    y = _dispatch_local(moe.w_gate, moe.w_up, moe.w_down, x, weights, idx,
                        cfg, cap, 0)
    if hasattr(moe, "shared"):
        y = y + L.ffn(moe.shared, x, cfg.ffn_act)
    return y.to(x.dtype), aux


def _dispatch_local(w_gate, w_up, w_down, x, weights, idx, cfg, cap: int,
                    e0: int):
    """The grouped dispatch's expert part for experts [e0, e0 + E_loc)
    (E_loc = w_gate.shape[0]): every slot routed to one of them is
    scattered into its buffer, the experts run, and each token gets the
    weighted sum of its slots' results (zero for slots of other
    experts)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    M = S * K
    E_loc = w_gate.shape[0]
    e_ids = idx.reshape(B, M)
    pos = slot_positions(e_ids, E)
    keep = pos < cap
    if E_loc != E:
        mine = (e_ids >= e0) & (e_ids < e0 + E_loc)
        keep = keep & mine
        e_ids = torch.where(mine, e_ids - e0, 0)
    safe = torch.where(keep, pos, cap - 1)
    tok = torch.arange(S, device=x.device).repeat_interleave(K)    # (M,)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, M)
    vals = torch.where(keep[..., None], x[:, tok], 0)              # (B,M,d)
    buf = torch.zeros((B, E_loc, cap, d), dtype=x.dtype,
                      device=x.device).index_put((rows, e_ids, safe), vals,
                                                 accumulate=True)
    g = L.ACTS[cfg.ffn_act](torch.einsum("becd,edf->becf", buf, w_gate))
    u = torch.einsum("becd,edf->becf", buf, w_up)
    yb = torch.einsum("becf,efd->becd", g * u, w_down)           # (B,E,cap,d)
    got = torch.where(keep[..., None], yb[rows, e_ids, safe], 0)
    return torch.einsum("bskd,bsk->bsd", got.reshape(B, S, K, d),
                        weights.to(x.dtype))


def _mesh_layout(x):
    """(mesh, the data axes x's batch is split over, whether it is)."""
    from repro_torch.sharding.rules import spec_of
    mesh = x.device_mesh
    b = spec_of(x)[0]
    return mesh, (() if b is None else (b,) if isinstance(b, str)
                  else tuple(b))


def _placements(mesh, by_axis: dict):
    """Placements from {axis name: placement}, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate
    return [by_axis.get(a, Replicate()) for a in mesh.mesh_dim_names]


def _grouped_sharded(moe: MoE, x, cfg, capacity_factor: float):
    """The grouped dispatch over a mesh: x (B, S, d) a DTensor, its batch
    over the data axes where it divides, replicated over `model`.  Routing
    runs on DTensors; then each rank takes its batch rows and its experts
    (`w_*` over `model`, gathered over the data axes: FSDP's gather) and
    computes their part of every token's output, which the ranks of
    `model` sum (a Partial placement, reduced by the next constraint)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    x = constrain(x, "dp", None, None)
    mesh, b_axes = _mesh_layout(x)
    B, S, d = x.shape
    E = cfg.num_experts
    weights, idx, aux = router_probs(moe, x, cfg)
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    if E % tp:
        raise NotImplementedError(f"{E} experts over a {tp}-way model axis")
    cap = capacity(S, cfg, capacity_factor)
    rows = {a: Shard(0) for a in b_axes}
    x_l = x.redistribute(mesh, _placements(mesh, rows)).to_local(
        grad_placements=_placements(mesh, {**rows, "model": Partial()}))
    w_l = [w.redistribute(mesh, _placements(mesh, {"model": Shard(0)}))
           .to_local(grad_placements=_placements(
               mesh, {"model": Shard(0), **{a: Partial() for a in b_axes}}))
           for w in (moe.w_gate, moe.w_up, moe.w_down)]
    wt_l = weights.redistribute(mesh, _placements(mesh, rows)).to_local(
        grad_placements=_placements(mesh, {**rows, "model": Partial()}))
    idx_l = idx.redistribute(mesh, _placements(mesh, rows)).to_local()
    e0 = (mesh.get_local_rank("model") * (E // tp)
          if "model" in mesh.mesh_dim_names else 0)
    y_l = _dispatch_local(*w_l, x_l, wt_l, idx_l, cfg, cap, e0)
    y = DTensor.from_local(y_l, mesh, _placements(
        mesh, {**rows, "model": Partial()}), run_check=False,
        shape=x.shape, stride=x.stride())
    y = constrain(y, "dp", None, None)
    if hasattr(moe, "shared"):
        y = y + L.ffn(moe.shared, x, cfg.ffn_act)
    return y.to(x.dtype), aux


class _GatherTokens(torch.autograd.Function):
    """All-gather of each rank's token rows over a group (dim 0); the
    gradient of a rank's rows is its slice of the gathered gradient (the
    output is replicated over the group, so each rank holds the whole
    gradient)."""

    @staticmethod
    def forward(ctx, y, group, rank: int, n: int):
        import torch.distributed._functional_collectives as funcol
        ctx.rank, ctx.rows = rank, y.shape[0]
        out = funcol.all_gather_tensor(y, 0, group)
        return out.wait() if hasattr(out, "wait") else out

    @staticmethod
    def backward(ctx, g):
        r = ctx.rows
        return g[ctx.rank * r:(ctx.rank + 1) * r], None, None, None


def moe_a2a_dispatch(moe: MoE, x, cfg, capacity_factor: float = 1.25):
    """Expert-parallel dispatch with explicit all-to-alls over `model`.

    Token-parallel: x (B, S, d) is replicated over `model`, and rank r of
    it routes its 1/tp slice of the B_loc * S tokens (B_loc the rows of
    its data shard).  Each rank's slots go to per-expert buffers of
    capacity cap = min(round(ceil(M/E) * cf), M), M = B_loc * S * K / tp;
    one all-to-all sends each expert's buffer to the rank that holds it,
    the experts run, a second all-to-all brings the rows back, the shared
    experts run on the rank's tokens, and the tokens are all-gathered over
    `model`.  Only routed capacity travels, (n-1)/n a direction.

    Falls back to `moe_grouped_dispatch` where `repro`'s does: no mesh (a
    plain tensor x), no `model` axis, experts that do not divide it, or
    tokens B_loc * S that do not.  The aux loss averages the router's
    statistics over every token (the grouped dispatch's), where `repro`'s
    shard_map returned one model rank's slice's (ROADMAP.md F12)."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    tp = 1 if mesh is None else dict(zip(mesh.mesh_dim_names,
                                          tuple(mesh.shape))).get("model")
    if (mesh is None or tp is None or cfg.num_experts % tp
            or not isinstance(x, DTensor)):
        return moe_grouped_dispatch(moe, x, cfg, capacity_factor)
    x = constrain(x, "dp", None, None)
    mesh, b_axes = _mesh_layout(x)
    B, S, d = x.shape
    B_loc = B // math.prod(dict(zip(mesh.mesh_dim_names, mesh.shape))[a]
                           for a in b_axes)
    if (B_loc * S) % tp:
        return moe_grouped_dispatch(moe, x, cfg, capacity_factor)
    return _a2a(moe, x, cfg, capacity_factor, mesh, b_axes, tp, B_loc)


def _a2a(moe: MoE, x, cfg, capacity_factor, mesh, b_axes, tp, B_loc):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Shard
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    E_loc = E // tp
    M = B_loc * S * K // tp
    cap = min(int(max(1, round(-(-M // E) * capacity_factor))), M)
    rows = {a: Shard(0) for a in b_axes}
    # gradients: each rank's tokens are its own, so what it computes for a
    # replicated input is its part of that input's gradient
    split = {**{a: Partial() for a in b_axes}, "model": Partial()}
    x_l = x.redistribute(mesh, _placements(mesh, rows)).to_local(
        grad_placements=_placements(mesh, {**rows, "model": Partial()}))
    router = moe.router.redistribute(mesh, _placements(mesh, {})).to_local(
        grad_placements=_placements(mesh, split))
    w_l = [w.redistribute(mesh, _placements(mesh, {"model": Shard(0)}))
           .to_local(grad_placements=_placements(
               mesh, {"model": Shard(0), **{a: Partial() for a in b_axes}}))
           for w in (moe.w_gate, moe.w_up, moe.w_down)]
    rank = mesh.get_local_rank("model")
    group = mesh.get_group("model")
    T_loc = B_loc * S // tp
    xt = x_l.reshape(B_loc * S, d)[rank * T_loc:(rank + 1) * T_loc]
    probs = torch.softmax(xt.float() @ router, dim=-1)            # (T, E)
    weights, idx = torch.topk(probs, K, dim=-1)
    if cfg.moe_renormalize:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
    hit = (F.one_hot(idx, E).sum(-2) > 0).float()
    m = T_loc * K
    e_ids = idx.reshape(1, m)
    pos = slot_positions(e_ids, E)[0]
    e_ids = e_ids[0]
    keep = pos < cap
    safe = torch.where(keep, pos, cap - 1)
    tok = torch.arange(T_loc, device=x_l.device).repeat_interleave(K)
    buf = torch.zeros((E, cap, d), dtype=x_l.dtype,
                      device=x_l.device).index_put(
        (e_ids, safe), torch.where(keep[:, None], xt[tok], 0),
        accumulate=True)
    # out: expert block i to model rank i; in: every rank's rows for mine
    buf = funcol.all_to_all_single_autograd(
        buf.reshape(tp * E_loc * cap, d), None, None, group)
    buf = buf.reshape(tp, E_loc, cap, d).transpose(0, 1).reshape(
        E_loc, tp * cap, d)
    g = L.ACTS[cfg.ffn_act](torch.einsum("ecd,edf->ecf", buf, w_l[0]))
    u = torch.einsum("ecd,edf->ecf", buf, w_l[1])
    yb = torch.einsum("ecf,efd->ecd", g * u, w_l[2])
    yb = yb.reshape(E_loc, tp, cap, d).transpose(0, 1).reshape(
        tp * E_loc * cap, d)
    yb = funcol.all_to_all_single_autograd(yb, None, None, group)
    yb = yb.reshape(E, cap, d)
    got = torch.where(keep[:, None], yb[e_ids, safe], 0).reshape(T_loc, K, d)
    y = torch.einsum("tkd,tk->td", got, weights.to(x_l.dtype))
    if hasattr(moe, "shared"):
        sh = moe.shared
        ws = [w.redistribute(mesh, _placements(mesh, {})).to_local(
            grad_placements=_placements(mesh, split))
            for w in (sh.w_gate, sh.w_up, sh.w_down)]
        y = y + (L.ACTS[cfg.ffn_act](xt @ ws[0]) * (xt @ ws[1])) @ ws[2]
    y = _GatherTokens.apply(y, group, rank, tp).reshape(B_loc, S, d)
    y = DTensor.from_local(y.to(x_l.dtype), mesh, _placements(mesh, rows),
                           run_check=False, shape=x.shape, stride=x.stride())
    # the aux loss over every token: the mean router statistics, averaged
    # over the ranks that hold the tokens (equal counts each)
    stats = DTensor.from_local(
        torch.stack([probs.mean(0), hit.mean(0)]), mesh,
        _placements(mesh, {**{a: Partial("avg") for a in b_axes},
                           "model": Partial("avg")}), run_check=False)
    stats = stats.redistribute(mesh, _placements(mesh, {}))
    aux = E * torch.sum(stats[0] * stats[1])
    return y, aux


def moe_ffn(moe: MoE, x: torch.Tensor, cfg):
    """cfg.moe_impl: "grouped" (production), "a2a" (expert-parallel over a
    mesh) or "dense" (the oracle)."""
    if cfg.moe_impl == "grouped":
        return moe_grouped_dispatch(moe, x, cfg,
                                    capacity_factor=cfg.moe_capacity_factor)
    if cfg.moe_impl == "a2a":
        return moe_a2a_dispatch(moe, x, cfg,
                                capacity_factor=cfg.moe_capacity_factor)
    return moe_dense_dispatch(moe, x, cfg)
