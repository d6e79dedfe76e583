"""Core model layers for the dense GQA decoder: RMSNorm, RoPE, GQA
projections, GLU FFN (decode attention is `kernels.ops.decode_attention`).

Parameters live in small `nn.Module`s whose names mirror `repro`'s parameter
tree; the layer functions take the module and the activations.  Weights keep
JAX's (in, out) layout, so every projection is `x @ w`.  Matmuls run in the
model dtype; normalisation and rotary statistics in fp32, then cast, as in
`repro/models/layers.py`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = param((d,), dtype, device)


class GQA(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, H, Hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.w_q = param((d, H * dh), cfg.dtype, device)
        self.w_k = param((d, Hk * dh), cfg.dtype, device)
        self.w_v = param((d, Hk * dh), cfg.dtype, device)
        self.w_o = param((H * dh, d), cfg.dtype, device)


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.w_gate = param((d_model, d_ff), dtype, device)
        self.w_up = param((d_model, d_ff), dtype, device)
        self.w_down = param((d_ff, d_model), dtype, device)


def rmsnorm(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (out * norm.scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles for positions (B, S), each
    (B, S, 1, head_dim/2) fp32.  `repro` recomputed them in every layer,
    where jit shares them; the port computes them once per step."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * inv              # (B, S, dh/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, rope: tuple) -> torch.Tensor:
    """x: (B, S, H, dh) rotated by `rope_table`'s (cos, sin), in fp32."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gqa_project_qkv(attn: GQA, x: torch.Tensor, cfg, rope: tuple):
    B, S, _ = x.shape
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ attn.w_q).reshape(B, S, H, dh)
    k = (x @ attn.w_k).reshape(B, S, Hk, dh)
    v = (x @ attn.w_v).reshape(B, S, Hk, dh)
    return apply_rope(q, rope), apply_rope(k, rope), v


def ffn(params: FFN, x: torch.Tensor) -> torch.Tensor:
    """SiLU-gated GLU (the only `ffn_act` ported)."""
    return (F.silu(x @ params.w_gate) * (x @ params.w_up)) @ params.w_down
