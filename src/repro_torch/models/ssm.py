"""State-space and recurrent mixers, ported from `repro/models/ssm.py`:
Mamba (the selective SSM of jamba-1.5-large-398b) and xLSTM's mLSTM.

Mamba: `mamba_mixer` (train and prefill; it returns the last state, which
the prefill cache keeps), its sequential oracle `mamba_mixer_ref`, and the
one-token `mamba_decode_step` with its state `mamba_state_init`.  Outside
autograd the scan is `kernels.ops.ssm_scan` (the CUDA kernel on the card,
its plain loop on the CPU), which takes the initial state and returns the
final one; under autograd it is the plain loop, which autograd
differentiates (the kernel has no backward, and `repro` has no
`custom_vjp`).  `repro` scanned in chunks of `ssm_chunk` (with a gcd
fallback for odd lengths), which changes only where it rounds; the port's
scan is unchunked, so `ssm_chunk` is data only, as `attn_impl` is.

mLSTM: the chunkwise-parallel `mlstm_mixer` (train and prefill), its
sequential oracle `mlstm_mixer_ref`, and the one-token `mlstm_decode_step`
with its state `mlstm_state_init`.

Layouts and types follow `repro`: activations (B, S, ·) in the model type;
Mamba's dt, B, C, the state h (B, di, N) and the scan's output in fp32;
the mLSTM's q, k, v (B, H, S, dh) and gates (B, H, S) in fp32.  `repro`
wrapped each chunk in `jax.checkpoint` to recompute it in the backward
pass; the port keeps autograd's saved activations (a memory trade, not a
numerical one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssm_scan_reference

from .layers import param, silu


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


# ---------------------------------------------------------------- Mamba

class Mamba(nn.Module):
    """Parameters of one Mamba mixer (Mamba-1, diagonal A); names and (in,
    out) layouts follow `repro`'s `mamba_init`.  dt_bias, A_log and D are
    fp32, the rest in the model type."""

    def __init__(self, cfg, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        di, N = cfg.ssm_d_inner, cfg.ssm_state_dim
        dtr, dc = cfg.ssm_dt_rank, cfg.ssm_conv_dim
        f32 = torch.float32
        self.in_proj = param((d, 2 * di), dt, device)
        self.conv_w = param((dc, di), dt, device)
        self.conv_b = param((di,), dt, device)
        self.x_proj = param((di, dtr + 2 * N), dt, device)
        self.dt_proj = param((dtr, di), dt, device)
        self.dt_bias = param((di,), f32, device)
        self.A_log = param((di, N), f32, device)
        self.D = param((di,), f32, device)
        self.out_proj = param((di, d), dt, device)

    @staticmethod
    def init_rules(cfg) -> tuple[dict, dict]:
        """`mamba_init`'s (constant values, fixed init stds) by leaf: A =
        1..N for every channel (A_log its log), D 1, dt_bias the inverse
        softplus of 0.01, a zero conv bias; the conv taps at std
        1/sqrt(dc)."""
        N = cfg.ssm_state_dim
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32))
        dt_bias = torch.log(torch.expm1(torch.tensor(0.01)))
        return ({"conv_b": 0.0, "dt_bias": dt_bias, "A_log": a_log,
                 "D": 1.0},
                {"conv_w": 1.0 / math.sqrt(cfg.ssm_conv_dim)})


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`'s formula, logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _mamba_inputs(p: Mamba, x: torch.Tensor, cfg):
    """`repro`'s pre-scan computation.  x: (B,S,d) -> (dt (B,S,di) fp32,
    B_ssm and C_ssm (B,S,N) fp32, z and x_conv (B,S,di) in x's type)."""
    N, dtr = cfg.ssm_state_dim, cfg.ssm_dt_rank
    x_in, z = (x @ p.in_proj).chunk(2, dim=-1)
    x_conv = silu(causal_conv1d(x_in, p.conv_w, p.conv_b))
    dbc = x_conv @ p.x_proj
    B_ssm = dbc[..., dtr:dtr + N].float()
    C_ssm = dbc[..., dtr + N:].float()
    dt = softplus(dbc[..., :dtr] @ p.dt_proj + p.dt_bias).float()
    return dt, B_ssm, C_ssm, z, x_conv


def _mamba_out(p: Mamba, y: torch.Tensor, x_conv: torch.Tensor,
               z: torch.Tensor, x_dtype) -> torch.Tensor:
    """The D*x skip added to the scan's fp32 y, the cast to the model type,
    the SiLU gate and the output projection."""
    y = y + p.D * x_conv.float()
    return (y.to(x_dtype) * silu(z)) @ p.out_proj


def mamba_mixer(p: Mamba, x: torch.Tensor, cfg, h0=None):
    """Full-sequence Mamba mixer.  x: (B,S,d); h0: (B,di,N) fp32, the state
    before the first step (zero if None).  Returns (y (B,S,d), h_last
    (B,di,N) fp32).  The scan is `ops.ssm_scan` unless autograd records
    (then the plain loop, which it differentiates)."""
    dt, B_ssm, C_ssm, z, x_conv = _mamba_inputs(p, x, cfg)
    args = (dt, x_conv, B_ssm, C_ssm, p.A_log)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y, h_last = ssm_scan_reference(*args, h0=h0, return_state=True)
    else:
        y, h_last = ops.ssm_scan(*args, h0=h0, return_state=True)
    return _mamba_out(p, y, x_conv, z, x.dtype), h_last


def mamba_mixer_ref(p: Mamba, x: torch.Tensor, cfg) -> torch.Tensor:
    """Sequential oracle: the plain loop over every step, from zero state,
    whatever the device."""
    dt, B_ssm, C_ssm, z, x_conv = _mamba_inputs(p, x, cfg)
    y = ssm_scan_reference(dt, x_conv, B_ssm, C_ssm, p.A_log)
    return _mamba_out(p, y, x_conv, z, x.dtype)


def mamba_decode_step(p: Mamba, x: torch.Tensor, state: dict, cfg):
    """One-token decode.  x: (B,1,d); state: {"h": (B,di,N) fp32, "conv":
    (B,dc-1,di)}.  Returns (y (B,1,d), new state); the inputs are not
    written.  `repro`'s rounding points: the conv window summed by einsum
    in the model type, dt, B and C in fp32."""
    N, dtr = cfg.ssm_state_dim, cfg.ssm_dt_rank
    x_in, z = (x @ p.in_proj).chunk(2, dim=-1)                  # (B,1,di)
    conv_buf = torch.cat([state["conv"], x_in], dim=1)          # (B,dc,di)
    x_conv = silu(torch.einsum("bcd,cd->bd", conv_buf, p.conv_w)
                  + p.conv_b)[:, None]                          # (B,1,di)
    dbc = x_conv @ p.x_proj
    B_ssm = dbc[..., dtr:dtr + N].float()[:, 0]
    C_ssm = dbc[..., dtr + N:].float()[:, 0]
    dt = softplus(dbc[..., :dtr] @ p.dt_proj + p.dt_bias).float()[:, 0]
    xc = x_conv.float()[:, 0]                                   # (B,di)
    dA = torch.exp(dt[..., None] * -torch.exp(p.A_log))         # (B,di,N)
    h = dA * state["h"] + (dt * xc)[..., None] * B_ssm[:, None, :]
    y = torch.einsum("bds,bs->bd", h, C_ssm) + p.D * xc
    y = y[:, None].to(x.dtype) * silu(z)
    return y @ p.out_proj, {"h": h, "conv": conv_buf[:, 1:]}


def mamba_state_init(B: int, cfg, device) -> dict:
    """The decode state before any token: a zero fp32 h (B, di, N) and a
    zero conv window (B, dc-1, di) in the model type."""
    di = cfg.ssm_d_inner
    return {"h": torch.zeros((B, di, cfg.ssm_state_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.ssm_conv_dim - 1, di),
                                dtype=cfg.dtype, device=device)}


# ---------------------------------------------------------------- mLSTM

class MLSTM(nn.Module):
    """Parameters of one mLSTM block body; names and (in, out) layouts follow
    `repro`'s `mlstm_init`.  The gate projections are fp32, the rest in the
    model type."""

    @staticmethod
    def init_rules(cfg) -> tuple[dict, dict]:
        """`mlstm_init`'s (constant values, fixed init stds) by leaf: zero
        biases but the forget gate's, open at 3."""
        return ({"conv_b": 0.0, "b_i": 0.0, "b_f": 3.0},
                {"conv_w": 0.5, "w_i": 0.02, "w_f": 0.02})

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
    hg = _group_norm_heads(h.reshape(B, S, H, dp // H))
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


def _group_norm_heads(h: torch.Tensor) -> torch.Tensor:
    """Per-head normalisation over the last dim, population variance."""
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, correction=0)
    return (h - mu) * torch.rsqrt(var + 1e-6)


def mlstm_decode_step(p: MLSTM, x: torch.Tensor, state: dict, cfg):
    """One-token decode.  x: (B,1,d); state: {"carry": (C, n, m), "conv":
    (B, dc-1, dp)}.  Returns (y (B,1,d), new state); the inputs are not
    written.  `repro`'s rounding points: the conv window summed by einsum in
    the model type; q and k from the conv output, v from the pre-conv input,
    all cast to fp32 and k then scaled by 1/sqrt(dh); the gates from the
    conv output in fp32."""
    B = x.shape[0]
    dp = cfg.mlstm_proj_factor * cfg.d_model
    H = cfg.num_heads
    dh = dp // H
    x_in, z = (x @ p.up_proj).chunk(2, dim=-1)                  # (B,1,dp)
    conv_buf = torch.cat([state["conv"], x_in], dim=1)          # (B,dc,dp)
    x_conv = silu(torch.einsum("bcd,cd->bd", conv_buf, p.conv_w) + p.conv_b)
    qt = (x_conv @ p.w_q).reshape(B, H, dh).float()
    kt = (x_conv @ p.w_k).reshape(B, H, dh).float() / math.sqrt(dh)
    vt = (x_in[:, 0] @ p.w_v).reshape(B, H, dh).float()
    it = x_conv.float() @ p.w_i + p.b_i
    ft = x_conv.float() @ p.w_f + p.b_f
    h, carry = _mlstm_cell_step(qt, kt, vt, it, ft, state["carry"])
    h = (_group_norm_heads(h).reshape(B, dp) * p.gn_scale).to(x.dtype)
    h = (h * silu(z[:, 0]))[:, None]
    return h @ p.down_proj, {"carry": carry, "conv": conv_buf[:, 1:]}


def mlstm_state_init(B: int, cfg, device) -> dict:
    """The decode state before any token: zero C and n, m at -60, a zero
    conv window in the model type."""
    dp = cfg.mlstm_proj_factor * cfg.d_model
    return {"carry": mlstm_carry_init(B, cfg.num_heads, dp // cfg.num_heads,
                                      device),
            "conv": torch.zeros((B, cfg.ssm_conv_dim - 1, dp),
                                dtype=cfg.dtype, device=device)}
