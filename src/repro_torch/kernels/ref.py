"""Plain-PyTorch oracles for the port's kernels (the allclose references),
copied from `repro/kernels/ref.py`."""
from __future__ import annotations

import math

import torch


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        kv_len=None) -> torch.Tensor:
    """q: (B,Sq,H,d); k,v: (B,Skv,Hk,d).  fp32 softmax, GQA by repeat;
    the masks use absolute positions (query row i is position i).  Returns
    q.dtype."""
    B, Sq, H, d = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
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
                               v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """q: (B,1,H,d) against (B,Skv,Hk,d) caches with kv_len valid entries
    (scalar or (B,)).  fp32 softmax, GQA by repeat; returns q.dtype."""
    B, _, H, d = q.shape
    Skv, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    k = k_cache.float().repeat_interleave(G, dim=2)
    v = v_cache.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(d)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1).expand(B)
    mask = torch.arange(Skv, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def ssm_scan_reference(dt: torch.Tensor, x: torch.Tensor, B_ssm: torch.Tensor,
                       C_ssm: torch.Tensor, A_log: torch.Tensor) -> torch.Tensor:
    """Sequential selective scan, one step at a time.  dt, x: (B,S,di);
    B_ssm, C_ssm: (B,S,N); A_log: (di,N).  Returns fp32 y (B,S,di)."""
    Bsz, S, di = x.shape
    N = B_ssm.shape[-1]
    A = -torch.exp(A_log.float())
    dtf = dt.float()
    bx = dtf * x.float()
    Bf, Cf = B_ssm.float(), C_ssm.float()
    h = torch.zeros((Bsz, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * A)                 # (B, di, N)
        h = dA * h + bx[:, t, :, None] * Bf[:, t, None, :]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1)
