"""Plain-PyTorch oracles for the port's kernels (the allclose references)."""
from __future__ import annotations

import math

import torch


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
