"""Mixture-of-Experts FFN with top-k routing and optional shared experts.

Port of `repro/models/moe.py`, with its two execution paths:
  * `moe_dense_dispatch`, the plain oracle: every expert runs on every
    token and the results are combined with the (sparse) routing weights;
  * `moe_grouped_dispatch`, the production path: each batch row is a
    dispatch group whose slots go to per-expert buffers of capacity
    C = round(ceil(K*S/E) * capacity_factor); the experts run only on their
    buffers, and slots past an expert's capacity are dropped.

The expert products are `torch.einsum` (batched matmuls), as `repro`
computed them outside any Pallas kernel.  `repro`'s third path, the
all-to-all dispatch over a mesh's model axis, belongs with the port's
multi-device work (ROADMAP.md §1 item 6); `ModelConfig` refuses it.

Weights keep `repro`'s layout: the router (d, E) in fp32, the experts
(E, d, f) and (E, f, d), so that `init_params` reads the leading dim as the
fan-in as `repro`'s `dense_init` does (the experts drawn with std 1/sqrt(E)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    M = S * K
    weights, idx, aux = router_probs(moe, x, cfg)
    cap = capacity(S, cfg, capacity_factor)
    e_ids = idx.reshape(B, M)
    pos = slot_positions(e_ids, E)
    keep = pos < cap
    safe = torch.where(keep, pos, cap - 1)
    tok = torch.arange(S, device=x.device).repeat_interleave(K)    # (M,)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, M)
    vals = torch.where(keep[..., None], x[:, tok], 0)              # (B,M,d)
    buf = torch.zeros((B, E, cap, d), dtype=x.dtype,
                      device=x.device).index_put((rows, e_ids, safe), vals,
                                                 accumulate=True)
    g = L.ACTS[cfg.ffn_act](torch.einsum("becd,edf->becf", buf, moe.w_gate))
    u = torch.einsum("becd,edf->becf", buf, moe.w_up)
    yb = torch.einsum("becf,efd->becd", g * u, moe.w_down)       # (B,E,cap,d)
    got = torch.where(keep[..., None], yb[rows, e_ids, safe], 0)
    y = torch.einsum("bskd,bsk->bsd", got.reshape(B, S, K, d),
                     weights.to(x.dtype))
    if hasattr(moe, "shared"):
        y = y + L.ffn(moe.shared, x, cfg.ffn_act)
    return y.to(x.dtype), aux


def moe_ffn(moe: MoE, x: torch.Tensor, cfg):
    """cfg.moe_impl: "grouped" (production) or "dense" (the oracle)."""
    if cfg.moe_impl == "grouped":
        return moe_grouped_dispatch(moe, x, cfg,
                                    capacity_factor=cfg.moe_capacity_factor)
    return moe_dense_dispatch(moe, x, cfg)
