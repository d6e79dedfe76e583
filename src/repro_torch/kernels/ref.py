"""Plain-PyTorch oracles for the port's kernels (the allclose references),
copied from `repro/kernels/ref.py`."""
from __future__ import annotations

import math

import torch


def check_softcap(softcap: float | None) -> float:
    """The cap as the kernels take it, 0.0 for None; raises unless it is
    None or a positive finite number."""
    if softcap is None:
        return 0.0
    cap = float(softcap)
    if not 0.0 < cap < math.inf:
        raise ValueError(f"softcap must be None or positive and finite, "
                         f"got {softcap!r}")
    return cap


def cap_scores(s: torch.Tensor, softcap: float | None) -> torch.Tensor:
    """`repro`'s logit cap on fp32 scores s = q.k/sqrt(d): cap*tanh(s/cap),
    applied after the scale and before the mask and the softmax
    (`repro/models/layers.py:133-136`); None leaves s as it is."""
    if softcap is None:
        return s
    return torch.tanh(s / softcap) * softcap


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        kv_len=None,
                        softcap: float | None = None) -> torch.Tensor:
    """q: (B,Sq,H,d); k,v: (B,Skv,Hk,d).  fp32 softmax, GQA by repeat;
    the masks use absolute positions (query row i is position i); scores
    capped by `cap_scores`.  Returns q.dtype."""
    B, Sq, H, d = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = cap_scores(torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
                   / math.sqrt(d), softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask &= k_pos < kv_len
    s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, kv_len,
                               softcap: float | None = None,
                               return_lse: bool = False):
    """q: (B,1,H,d) against (B,Skv,Hk,d) caches with kv_len valid entries
    (scalar or (B,)).  fp32 softmax, GQA by repeat, scores capped by
    `cap_scores`; returns q.dtype, or (out, lse) with return_lse: out
    fp32, not rounded to q's type, and lse (B, H) fp32 the log-sum-exp of
    each row's visible scores."""
    B, _, H, d = q.shape
    Skv, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    k = k_cache.float().repeat_interleave(G, dim=2)
    v = v_cache.float().repeat_interleave(G, dim=2)
    s = cap_scores(torch.einsum("bqhd,bkhd->bhqk", q.float(), k)
                   / math.sqrt(d), softcap)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1).expand(B)
    mask = torch.arange(Skv, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)[:, :, 0]
    return out.to(q.dtype)


def ssm_scan_reference(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
                       C_ssm: torch.Tensor, A_log: torch.Tensor,
                       h0: torch.Tensor | None = None,
                       return_state: bool = False):
    """Sequential selective scan, one step at a time.  dt, x: (B,S,di);
    B_ssm, C_ssm: (B,S,N); A_log: (di,N); h0: (B,di,N), the state before
    step 0 (zero if None).  Returns fp32 y (B,S,di), or (y, h_last (B,di,N)
    fp32) with return_state.  Differentiable (a loop of torch ops)."""
    Bsz, S, di = x.shape
    N = B_ssm.shape[-1]
    A = -torch.exp(A_log.float())
    dtf = dt.float()
    bx = dtf * x.float()
    Bf, Cf = B_ssm.float(), C_ssm.float()
    h = (torch.zeros((Bsz, di, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * A)                 # (B, di, N)
        h = dA * h + bx[:, t, :, None] * Bf[:, t, None, :]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1)
    return (y, h) if return_state else y
