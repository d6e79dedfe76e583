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
from repro_torch.sharding.context import constrain
from repro_torch.kernels.ref import ssm_scan_reference

from .layers import (elementwise, merge_heads, param, row_parallel, silu,
                     split_last, unflatten)


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
    x_in, z = split_last(constrain(x @ p.in_proj, "dp", None, "tp"), 2)
    x_conv = silu(causal_conv1d(x_in, p.conv_w, p.conv_b))
    # x_proj's rows (the contraction) are the channels' split over a mesh
    dbc = row_parallel(x_conv, p.x_proj)
    B_ssm = dbc[..., dtr:dtr + N].float()
    C_ssm = dbc[..., dtr + N:].float()
    dt = softplus(dbc[..., :dtr] @ p.dt_proj + p.dt_bias).float()
    return constrain(dt, "dp", None, "tp"), B_ssm, C_ssm, z, x_conv


def _mamba_out(p: Mamba, y: torch.Tensor, x_conv: torch.Tensor,
               z: torch.Tensor, x_dtype) -> torch.Tensor:
    """The D*x skip added to the scan's fp32 y, the cast to the model type,
    the SiLU gate and the output projection."""
    y = y + p.D * x_conv.float()
    return row_parallel(y.to(x_dtype) * silu(z), p.out_proj)


def mamba_mixer(p: Mamba, x: torch.Tensor, cfg, h0=None):
    """Full-sequence Mamba mixer.  x: (B,S,d); h0: (B,di,N) fp32, the state
    before the first step (zero if None).  Returns (y (B,S,d), h_last
    (B,di,N) fp32).  The scan is `ops.ssm_scan` unless autograd records
    (then the plain loop, which it differentiates)."""
    dt, B_ssm, C_ssm, z, x_conv = _mamba_inputs(p, x, cfg)
    args = (dt, x_conv, B_ssm, C_ssm, p.A_log)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y, h_last = ops.ssm_scan_differentiable(*args, h0=h0,
                                                return_state=True)
    else:
        y, h_last = ops.ssm_scan(*args, h0=h0, return_state=True)
    y = constrain(y, "dp", None, "tp")
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
    x_in, z = split_last(x @ p.in_proj, 2)                      # (B,1,di)
    conv_buf = torch.cat([state["conv"], x_in], dim=1)          # (B,dc,di)
    x_conv = silu(torch.einsum("bcd,cd->bd", conv_buf, p.conv_w)
                  + p.conv_b)[:, None]                          # (B,1,di)
    dbc = row_parallel(x_conv, p.x_proj)
    B_ssm = dbc[..., dtr:dtr + N].float()[:, 0]
    C_ssm = dbc[..., dtr + N:].float()[:, 0]
    dt = softplus(dbc[..., :dtr] @ p.dt_proj + p.dt_bias).float()[:, 0]
    xc = x_conv.float()[:, 0]                                   # (B,di)
    dA = torch.exp(dt[..., None] * -torch.exp(p.A_log))         # (B,di,N)
    h = dA * state["h"] + (dt * xc)[..., None] * B_ssm[:, None, :]
    y = torch.einsum("bds,bs->bd", h, C_ssm) + p.D * xc
    y = y[:, None].to(x.dtype) * silu(z)
    return row_parallel(y, p.out_proj), {"h": h, "conv": conv_buf[:, 1:]}


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


def _mlstm_flat(p: MLSTM, x_in: torch.Tensor):
    """x_in: (B,S,dp) (post up-proj mlstm branch).  Returns x_conv and the
    flat q, k and v projections (B,S,dp) in the model type, and the raw
    gate pre-activations i, f (B,S,H) fp32."""
    x_conv = silu(causal_conv1d(x_in, p.conv_w, p.conv_b))
    gates = tuple(x_conv.float() @ w + b
                  for w, b in ((p.w_i, p.b_i), (p.w_f, p.b_f)))
    return (x_conv @ p.w_q, x_conv @ p.w_k, x_in @ p.w_v) + gates


def _mlstm_qkvif(p: MLSTM, x_in: torch.Tensor, cfg):
    """x_in: (B,S,dp) (post up-proj mlstm branch).  Returns q,k,v (B,H,S,dh)
    fp32 and gates i,f (B,H,S) fp32 (raw pre-activations)."""
    B, S, dp = x_in.shape
    H = cfg.num_heads
    dh = dp // H
    qf, kf, vf, i_raw, f_raw = _mlstm_flat(p, x_in)

    def to_heads(a):
        return constrain(unflatten(a, B, S, H, dh).transpose(1, 2).float(),
                         "dp", None, None, "tp")

    q = to_heads(qf)
    k = to_heads(kf) / math.sqrt(dh)
    v = to_heads(vf)
    return q, k, v, i_raw.transpose(1, 2), f_raw.transpose(1, 2)


def _mlstm_chunk(q, k, v, i_raw, f_raw, carry):
    """One chunk of stabilized mLSTM.  All (B,H,L,·) fp32.
    carry = (C (B,H,dh,dh), n (B,H,dh), m (B,H))."""
    C_p, n_p, m_p = carry
    L = q.shape[2]
    logf = elementwise(F.logsigmoid, f_raw)               # (B,H,L)
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


def _mlstm_out(p: MLSTM, hg: torch.Tensor, z: torch.Tensor,
               x_dtype) -> torch.Tensor:
    """The group-normed heads' scale, the output gate and the down
    projection.  hg: (B,S,dp) fp32."""
    h = (hg * p.gn_scale).to(x_dtype) * silu(z)
    return row_parallel(h, p.down_proj)


def mlstm_mixer(p: MLSTM, x: torch.Tensor, cfg, carry=None):
    """Full mLSTM block body, chunkwise parallel.  x: (B,S,d) ->
    (y (B,S,d), carry).  Over a mesh whose `model` axis splits the
    channels, each rank runs the chunks on its share of the (batch row,
    head) cells (`_Cells`); where the channels are whole over `model`, on
    its own batch rows."""
    from torch.distributed.tensor import DTensor
    B, S, d = x.shape
    dp = cfg.mlstm_proj_factor * d
    H = cfg.num_heads
    dh = dp // H
    x_in, z = split_last(x @ p.up_proj, 2)
    cs = min(cfg.ssm_chunk, S)
    if S % cs:
        cs = math.gcd(S, cs)
    if isinstance(x_in, DTensor):
        from repro_torch.sharding.context import current_mesh, resolve
        mesh = current_mesh()
        if resolve(mesh, ("dp", None, "tp"), x_in.shape)[2] is not None:
            hg, carry = _mlstm_cells(p, x_in, cfg, carry, cs)
            return _mlstm_out(p, hg, z, x.dtype), carry
    q, k, v, i_raw, f_raw = _mlstm_qkvif(p, x_in, cfg)
    if carry is None:
        carry = mlstm_carry_init(B, H, dh, x.device)
    if isinstance(q, DTensor):
        # q, k and v are whole over `model` here (their channels do not
        # divide it, or it has one rank): each rank runs its batch rows
        from repro_torch.sharding.context import batch_local
        h, carry = batch_local(_mlstm_chunks, q, k, v, i_raw, f_raw, carry,
                               cs)
    else:
        h, carry = _mlstm_chunks(q, k, v, i_raw, f_raw, carry, cs)
    hg = merge_heads(_group_norm_heads(h.transpose(1, 2)), B, S, dp)
    return _mlstm_out(p, hg, z, x.dtype), carry


def _mlstm_chunks(q, k, v, i_raw, f_raw, carry, cs: int):
    """The chunk loop: (h (B,H,S,dh), carry)."""
    S = q.shape[2]
    hs = []
    for c0 in range(0, S, cs):
        sl = slice(c0, c0 + cs)
        h, carry = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                i_raw[:, :, sl], f_raw[:, :, sl], carry)
        hs.append(h)
    return torch.cat(hs, dim=2), carry


class _Cells:
    """An mLSTM's (batch row, head) cells over a mesh with a `model` axis
    of tp ranks: the chunk loop, the carry and the group norm are per cell,
    so model rank j runs the j-th of tp near-equal runs of its batch rows'
    c = B_l * H cells (cell g = b * H + h; a rank may have none).  A tensor
    split over `model` along a dim of the cell (`span(g, i)`: the part of
    cell g that rank i holds) moves to and from the cells in one
    all_to_all over `model`: each rank sends each cell's part to the
    cell's rank.  No tensor is gathered whole on every rank; one whole
    over `model` is cut to each rank's cells, and the carry's m, whole
    over `model` in the cache, is gathered (c floats)."""

    def __init__(self, mesh, B_l: int, H: int):
        self.mesh = mesh
        self.group = mesh.get_group("model")
        self.tp = mesh.shape[mesh.mesh_dim_names.index("model")]
        self.r = mesh.get_local_rank("model")
        c = B_l * H
        n = [c // self.tp + (j < c % self.tp) for j in range(self.tp)]
        self.own = [range(sum(n[:j]), sum(n[:j + 1]))
                    for j in range(self.tp)]
        self.mine = self.own[self.r]

    def _a2a(self, send: list, shapes: list, like: torch.Tensor):
        """send[j]: this rank's pieces for rank j; shapes[i]: the shapes of
        rank i's pieces for this rank.  Returns (those pieces in order, the
        buffer received).  An empty buffer is cut from `like`, so that
        every rank's autograd graph holds the collective."""
        import torch.distributed._functional_collectives as funcol
        flat = [t.reshape(-1) for ts in send for t in ts]
        buf = torch.cat(flat) if flat else like.reshape(-1)[:0]
        sizes = [math.prod(s) for ss in shapes for s in ss]
        out = funcol.all_to_all_single_autograd(
            buf, [sum(math.prod(s) for s in ss) for ss in shapes],
            [sum(t.numel() for t in ts) for ts in send], self.group)
        pieces = torch.split(out, sizes) if sizes else ()
        return [t.reshape(s) for t, s in
                zip(pieces, [s for ss in shapes for s in ss])], out

    def to_cells(self, piece, span, cell: tuple, ax: int,
                 like: torch.Tensor) -> torch.Tensor:
        """(n_mine, *cell): this rank's cells, assembled along dim ax of the
        cell from every rank's part; piece(g) is this rank's part of cell
        g (a view of `like`), span(g, i) rank i's (e0, e1) of dim ax."""
        def shape(g, i):
            e0, e1 = span(g, i)
            return cell[:ax] + (e1 - e0,) + cell[ax + 1:]
        send = [[piece(g) for g in self.own[j] if _some(span(g, self.r))]
                for j in range(self.tp)]
        got, out = self._a2a(send, [[shape(g, i) for g in self.mine
                                     if _some(span(g, i))]
                                    for i in range(self.tp)], like)
        parts: dict = {}
        for (g, _), t in zip([(g, i) for i in range(self.tp)
                              for g in self.mine if _some(span(g, i))], got):
            parts.setdefault(g, []).append(t)
        if not parts:
            return out[:0].reshape((0,) + cell)
        return torch.stack([torch.cat(parts[g], dim=ax) for g in self.mine])

    def from_cells(self, cells: torch.Tensor, span, ax: int) -> dict:
        """The inverse: {g: this rank's part of cell g} for every cell of
        which it holds a part, from the cells' ranks."""
        send = [[cells[q].narrow(ax, *_start_len(span(g, j)))
                 for q, g in enumerate(self.mine) if _some(span(g, j))]
                for j in range(self.tp)]
        keys = [g for i in range(self.tp) for g in self.own[i]
                if _some(span(g, self.r))]
        cell = tuple(cells.shape[1:])
        shapes = [[cell[:ax] + (_start_len(span(g, self.r))[1],)
                   + cell[ax + 1:] for g in self.own[i]
                   if _some(span(g, self.r))] for i in range(self.tp)]
        got, _ = self._a2a(send, shapes, cells)
        return dict(zip(keys, got))

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's cells of a local (B_l, H, ...) shard whole over
        `model`: (n_mine, ...)."""
        flat = t.reshape((-1,) + tuple(t.shape[2:]))
        return flat[self.mine.start:self.mine.stop]

    def gather(self, cells: torch.Tensor) -> torch.Tensor:
        """Every rank's cells, in order, on every rank: (c, ...), through a
        DTensor over `model`, so that the gradient is each rank's own
        part."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        n = max(len(o) for o in self.own)
        pad = torch.cat([cells, cells.new_zeros(
            (n - len(self.mine),) + tuple(cells.shape[1:]))])
        sub = self.mesh["model"]
        full = DTensor.from_local(pad, sub, [Shard(0)], run_check=False) \
            .redistribute(sub, [Replicate()]).to_local()
        return torch.cat([full[j * n:j * n + len(o)]
                          for j, o in enumerate(self.own)])


def _some(span) -> bool:
    return span[1] > span[0]


def _start_len(span) -> tuple:
    return span[0], span[1] - span[0]


def _mlstm_cells(p: MLSTM, x_in, cfg, carry, cs: int):
    """The chunk loop and the group norm over a mesh whose `model` axis
    splits the flat channels (H * dh) of q, k and v in contiguous blocks
    (w = H * dh / tp a rank; a head may span ranks, or a rank hold
    several heads).  q, k and v go to the cells' ranks and the normed
    heads come back in the same blocks: one all_to_all each, the data
    GSPMD moves to split `repro`'s dh over `model` and back.  The gates
    (B,S,H), whole over `model` after their contraction's all-reduce, are
    cut to each rank's cells (their gradient a partial sum over `model`).
    The carry (`carry`, or a zero one) goes in and comes out in the
    cache's layout (`sharding.rules`: C and n with dk over `model` where it
    divides, m whole over it).  Returns (hg (B,S,dp) fp32 in q's channel
    layout, carry)."""
    from torch.distributed.tensor import Partial
    from repro_torch.sharding.context import (current_mesh, from_shard,
                                              resolve, to_layout)
    from repro_torch.sharding.rules import placements
    mesh = current_mesh()
    B, S, dp = x_in.shape
    H = cfg.num_heads
    dh = dp // H
    qf, kf, vf, i_raw, f_raw = _mlstm_flat(p, x_in)
    flat = resolve(mesh, ("dp", None, "tp"), (B, S, dp))
    qf, kf, vf = (to_layout(t, mesh, flat).to_local() for t in (qf, kf, vf))
    B_l = qf.shape[0]
    cells = _Cells(mesh, B_l, H)
    w = dp // cells.tp

    def flat_span(g, i):
        h = g % H
        return (max(h * dh, i * w) - h * dh,
                max(min((h + 1) * dh, (i + 1) * w) - h * dh, 0))

    def flat_piece(t):
        def piece(g):
            b, h = divmod(g, H)
            e0, e1 = flat_span(g, cells.r)
            return t[b, :, h * dh + e0 - cells.r * w:h * dh + e1 - cells.r * w]
        return piece

    q, k, v = (cells.to_cells(flat_piece(t), flat_span, (S, dh), 1,
                              t).float() for t in (qf, kf, vf))
    k = k / math.sqrt(dh)
    whole = resolve(mesh, ("dp", None, None), (B, S, H))
    grad_pl = [Partial() if n == "model" else pl for n, pl in zip(
        mesh.mesh_dim_names, placements(mesh, whole))]
    i_c, f_c = (cells.cut(to_layout(t, mesh, whole).to_local(
        grad_placements=grad_pl).transpose(1, 2)) for t in (i_raw, f_raw))

    # the carry: C (B,H,dk,dv) and n (B,H,dk) split along dk as the cache
    specs = {"C": resolve(mesh, ("dp", None, "tp", None), (B, H, dh, dh)),
             "n": resolve(mesh, ("dp", None, "tp"), (B, H, dh)),
             "m": resolve(mesh, ("dp", None), (B, H))}

    def dk_span(name):
        """Rank i's part of dk in each cell of C or n; None where the
        leaf is whole over `model` (m always)."""
        if name == "m" or specs[name][2] is None:
            return None
        dl = dh // cells.tp
        return lambda g, i: (i * dl, (i + 1) * dl)

    if carry is None:
        carry = mlstm_carry_init(len(cells.mine), 1, dh, qf.device)
    else:
        ins = []
        for name, t in zip("Cnm", carry):
            pl = placements(mesh, specs[name])
            t = to_layout(t, mesh, specs[name])
            span = dk_span(name)
            if span is None:
                t = cells.cut(t.to_local(grad_placements=[
                    Partial() if n == "model" else x
                    for n, x in zip(mesh.mesh_dim_names, pl)]))
            else:
                tl = t.to_local()
                t = cells.to_cells(lambda g, tl=tl: tl[divmod(g, H)],
                                   span, tuple(t.shape[2:]), 0, tl)
            ins.append(t[:, None])
        carry = tuple(ins)
    h, carry = _mlstm_chunks(q[:, None], k[:, None], v[:, None],
                             i_c[:, None], f_c[:, None], carry, cs)
    hg = h[:, 0]                                              # (n, S, dh)
    hg = _group_norm_heads(hg) if len(cells.mine) else hg
    parts = cells.from_cells(hg, flat_span, 1)
    rows = [torch.cat([parts[g] for g in range(b * H, (b + 1) * H)
                       if g in parts], dim=-1) for b in range(B_l)]
    hg = from_shard(torch.stack(rows), mesh, placements(mesh, flat),
                    (B, S, dp))

    out = []
    for name, t, full in zip("Cnm", carry,
                             ((B, H, dh, dh), (B, H, dh), (B, H))):
        t = t[:, 0]
        span = dk_span(name)
        if span is None:
            local = cells.gather(t).reshape((B_l, H) + tuple(t.shape[1:]))
        else:
            got = cells.from_cells(t, span, 0)
            local = torch.stack([got[g] for g in range(B_l * H)]).reshape(
                (B_l, H) + tuple(got[0].shape))
        out.append(from_shard(local, mesh, placements(mesh, specs[name]),
                              full))
    return hg, tuple(out)


def _mlstm_cell_step(qt, kt, vt, it, ft, carry):
    """Single-step stabilized mLSTM cell.  qt,kt,vt: (B,H,dh); it,ft: (B,H)."""
    C_p, n_p, m_p = carry
    logf = elementwise(F.logsigmoid, ft)
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
    hg = merge_heads(_group_norm_heads(torch.stack(hs, dim=1)), B, S, dp)
    return _mlstm_out(p, hg, z, x.dtype)


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
    x_in, z = split_last(x @ p.up_proj, 2)                      # (B,1,dp)
    conv_buf = torch.cat([state["conv"], x_in], dim=1)          # (B,dc,dp)
    x_conv = silu(torch.einsum("bcd,cd->bd", conv_buf, p.conv_w) + p.conv_b)
    qt = unflatten(x_conv @ p.w_q, B, H, dh).float()
    kt = unflatten(x_conv @ p.w_k, B, H, dh).float() / math.sqrt(dh)
    vt = unflatten(x_in[:, 0] @ p.w_v, B, H, dh).float()
    it = x_conv.float() @ p.w_i + p.b_i
    ft = x_conv.float() @ p.w_f + p.b_f
    h, carry = _mlstm_cell_step(qt, kt, vt, it, ft, state["carry"])
    h = (_group_norm_heads(h).reshape(B, dp) * p.gn_scale).to(x.dtype)
    h = (h * silu(z[:, 0]))[:, None]
    return row_parallel(h, p.down_proj), {"carry": carry,
                                          "conv": conv_buf[:, 1:]}


def mlstm_state_init(B: int, cfg, device) -> dict:
    """The decode state before any token: zero C and n, m at -60, a zero
    conv window in the model type."""
    dp = cfg.mlstm_proj_factor * cfg.d_model
    return {"carry": mlstm_carry_init(B, cfg.num_heads, dp // cfg.num_heads,
                                      device),
            "conv": torch.zeros((B, cfg.ssm_conv_dim - 1, dp),
                                dtype=cfg.dtype, device=device)}
