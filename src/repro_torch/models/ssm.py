"""xLSTM's mLSTM mixer (matrix memory with exponential gating), ported from
`repro/models/ssm.py` for the train/prefill path: the chunkwise-parallel
`mlstm_mixer` and its sequential oracle `mlstm_mixer_ref`.  The Mamba mixer
and the one-token decode steps wait for the rest of the model zoo.

Layouts and types follow `repro`: activations (B, S, ·) in the model type,
q, k, v (B, H, S, dh) and the gates (B, H, S) in fp32.  `repro` wrapped each
chunk in `jax.checkpoint` to recompute the (L, L) gate matrices in the
backward pass; the port keeps them (a memory trade, not a numerical one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import param


class MLSTM(nn.Module):
    """Parameters of one mLSTM block body; names and (in, out) layouts follow
    `repro`'s `mlstm_init`.  The gate projections are fp32, the rest in the
    model type."""

    def __init__(self, cfg, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        dp = cfg.mlstm_proj_factor * d
        H = cfg.num_heads
        f32 = torch.float32
        self.up_proj = param((d, 2 * dp), dt, device)
        self.conv_w = param((cfg.ssm_conv_dim, dp), dt, device)
        self.conv_b = param((dp,), dt, device)
        self.w_q = param((dp, dp), dt, device)
        self.w_k = param((dp, dp), dt, device)
        self.w_v = param((dp, dp), dt, device)
        self.w_i = param((dp, H), f32, device)
        self.b_i = param((H,), f32, device)
        self.w_f = param((dp, H), f32, device)
        self.b_f = param((H,), f32, device)
        self.gn_scale = param((dp,), dt, device)
        self.down_proj = param((dp, d), dt, device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`'s own formula, x * (1 / (1 + exp(-x))), op by op in x's
    type.  `F.silu` rounds once; in bf16 that moves values by an ulp, which
    the mLSTM's normalisation then amplifies past the bf16 limit."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence dim.  x: (B,S,di), w: (dc,di).
    Summed tap by tap in the input type, in `repro`'s order."""
    dc, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, dc):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _mlstm_qkvif(p: MLSTM, x_in: torch.Tensor, cfg):
    """x_in: (B,S,dp) (post up-proj mlstm branch).  Returns q,k,v (B,H,S,dh)
    fp32 and gates i,f (B,H,S) fp32 (raw pre-activations)."""
    B, S, dp = x_in.shape
    H = cfg.num_heads
    dh = dp // H
    x_conv = silu(causal_conv1d(x_in, p.conv_w, p.conv_b))

    def to_heads(a):
        return a.reshape(B, S, H, dh).transpose(1, 2).float()

    q = to_heads(x_conv @ p.w_q)
    k = to_heads(x_conv @ p.w_k) / math.sqrt(dh)
    v = to_heads(x_in @ p.w_v)
    i_raw = x_conv.float() @ p.w_i + p.b_i
    f_raw = x_conv.float() @ p.w_f + p.b_f
    return q, k, v, i_raw.transpose(1, 2), f_raw.transpose(1, 2)


def _mlstm_chunk(q, k, v, i_raw, f_raw, carry):
    """One chunk of stabilized mLSTM.  All (B,H,L,·) fp32.
    carry = (C (B,H,dh,dh), n (B,H,dh), m (B,H))."""
    C_p, n_p, m_p = carry
    L = q.shape[2]
    logf = F.logsigmoid(f_raw)                            # (B,H,L)
    Fc = torch.cumsum(logf, dim=-1)                       # within the chunk
    # pairwise decay D[t,s] = F_t - F_s + i_s   (valid for s<=t)
    Dm = Fc[..., :, None] - Fc[..., None, :] + i_raw[..., None, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    # masked entries become exp(-inf) = 0 below; the gradient through
    # masked_fill is 0 there, so no inf reaches the backward pass
    Dm = Dm.masked_fill(~tri, -math.inf)
    m_intra = Dm.amax(dim=-1)                             # (B,H,L)
    m_t = torch.maximum(Fc + m_p[..., None], m_intra)
    m_t = torch.clamp(m_t, min=-60.0)                     # no inf ratios
    scores = torch.exp(Dm - m_t[..., None])               # (B,H,L,L)
    qk = torch.einsum("bhtd,bhsd->bhts", q, k)
    num = torch.einsum("bhts,bhsv->bhtv", scores * qk, v)
    den = (scores * qk).sum(-1)
    inter_w = torch.exp(Fc + m_p[..., None] - m_t)        # (B,H,L)
    num = num + inter_w[..., None] * torch.einsum("bhtd,bhdv->bhtv", q, C_p)
    den = den + inter_w * torch.einsum("bhtd,bhd->bht", q, n_p)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # ---- carry update to end of chunk
    m_new = torch.maximum(Fc[..., -1] + m_p, m_intra[..., -1])
    m_new = torch.clamp(m_new, min=-60.0)
    wS = torch.exp(Fc[..., -1:] - Fc + i_raw - m_new[..., None])   # (B,H,L)
    decay = torch.exp(Fc[..., -1] + m_p - m_new)
    C_new = (decay[..., None, None] * C_p
             + torch.einsum("bhs,bhsd,bhsv->bhdv", wS, k, v))
    n_new = decay[..., None] * n_p + torch.einsum("bhs,bhsd->bhd", wS, k)
    return h, (C_new, n_new, m_new)


def mlstm_carry_init(B: int, H: int, dh: int, device) -> tuple:
    return (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.full((B, H), -60.0, dtype=torch.float32, device=device))


def _mlstm_out(p: MLSTM, h: torch.Tensor, z: torch.Tensor, x_dtype,
               cfg) -> torch.Tensor:
    """Per-head group norm (population variance, as `jnp.var`), the output
    gate and the down projection.  h: (B,S,dp) fp32."""
    B, S, dp = h.shape
    H = cfg.num_heads
    hg = h.reshape(B, S, H, dp // H)
    mu = hg.mean(-1, keepdim=True)
    var = hg.var(-1, keepdim=True, correction=0)
    hg = (hg - mu) * torch.rsqrt(var + 1e-6)
    h = (hg.reshape(B, S, dp) * p.gn_scale).to(x_dtype)
    h = h * silu(z)
    return h @ p.down_proj


def mlstm_mixer(p: MLSTM, x: torch.Tensor, cfg, carry=None):
    """Full mLSTM block body, chunkwise parallel.  x: (B,S,d) ->
    (y (B,S,d), carry)."""
    B, S, d = x.shape
    dp = cfg.mlstm_proj_factor * d
    H = cfg.num_heads
    dh = dp // H
    x_in, z = (x @ p.up_proj).chunk(2, dim=-1)
    q, k, v, i_raw, f_raw = _mlstm_qkvif(p, x_in, cfg)
    cs = min(cfg.ssm_chunk, S)
    if S % cs:
        cs = math.gcd(S, cs)
    if carry is None:
        carry = mlstm_carry_init(B, H, dh, x.device)
    hs = []
    for c0 in range(0, S, cs):
        sl = slice(c0, c0 + cs)
        h, carry = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                i_raw[:, :, sl], f_raw[:, :, sl], carry)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, S, dp)   # (B,S,dp)
    return _mlstm_out(p, h, z, x.dtype, cfg), carry


def _mlstm_cell_step(qt, kt, vt, it, ft, carry):
    """Single-step stabilized mLSTM cell.  qt,kt,vt: (B,H,dh); it,ft: (B,H)."""
    C_p, n_p, m_p = carry
    logf = F.logsigmoid(ft)
    m_t = torch.maximum(logf + m_p, it)
    m_t = torch.clamp(m_t, min=-60.0)
    fw = torch.exp(logf + m_p - m_t)[..., None]
    iw = torch.exp(it - m_t)[..., None]
    C_t = fw[..., None] * C_p + iw[..., None] * kt[..., :, None] * vt[..., None, :]
    n_t = fw * n_p + iw * kt
    num = torch.einsum("bhd,bhdv->bhv", qt, C_t)
    den = torch.einsum("bhd,bhd->bh", qt, n_t)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    return h, (C_t, n_t, m_t)


def mlstm_mixer_ref(p: MLSTM, x: torch.Tensor, cfg) -> torch.Tensor:
    """Sequential per-step oracle."""
    B, S, d = x.shape
    dp = cfg.mlstm_proj_factor * d
    H = cfg.num_heads
    x_in, z = (x @ p.up_proj).chunk(2, dim=-1)
    q, k, v, i_raw, f_raw = _mlstm_qkvif(p, x_in, cfg)
    carry = mlstm_carry_init(B, H, dp // H, x.device)
    hs = []
    for t in range(S):
        h, carry = _mlstm_cell_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                    i_raw[:, :, t], f_raw[:, :, t], carry)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, dp)          # (B,S,H,dh) flat
    return _mlstm_out(p, h, z, x.dtype, cfg)
