"""Core model layers: RMSNorm, RoPE, GQA projections, cross-attention's
projections, MLA (multi-head latent attention: the latent, its expansion to
keys and values, and its attention), the train forward's attention
(materialised, or streamed over KV chunks past `_MATERIALIZE_LIMIT`), the
GLU FFN with a SiLU, GELU or ReLU gate (prefill and decode attention are
`kernels.ops.flash_attention` and `kernels.ops.decode_attention`).

Parameters live in small `nn.Module`s whose names mirror `repro`'s parameter
tree; the layer functions take the module and the activations.  Weights keep
JAX's (in, out) layout, so every projection is `x @ w`.  Matmuls run in the
model dtype; normalisation and rotary statistics in fp32, then cast, as in
`repro/models/layers.py`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ref import cap_scores
from repro_torch.sharding.context import (axis_index, constrain, from_shard,
                                          resolve, to_layout)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# above this many scores a head, attention streams over KV chunks
# (`attention_chunked`), as `repro`'s does
_MATERIALIZE_LIMIT = 4096 * 4096
_CHUNK_Q = _CHUNK_K = 2048


def recompute(fn, *args):
    """fn(*args), its activations recomputed in the backward
    (`torch.utils.checkpoint`, `repro`'s `jax.checkpoint`) when autograd
    records; a plain call when it does not.  The port's forwards draw no
    random numbers, so no RNG state is kept."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


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


class CrossAttention(GQA):
    """An encoder-decoder block's cross-attention (`repro`'s `cross`, laid
    out as GQA's): queries from the decoder, keys and values from the
    encoder's output."""


class MLA(nn.Module):
    """DeepSeek-V2's multi-head latent attention, `repro`'s `mla_init`
    layout: full-rank queries (q_lora_rank 0) of width dh + dr a head, the
    down projection to the latent (r), the shared rotary key (dr), the up
    projections of keys and values (dh a head) and the output."""

    def __init__(self, cfg, device):
        super().__init__()
        d, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        self.w_q = param((d, H * (dh + dr)), cfg.dtype, device)
        self.w_dkv = param((d, r), cfg.dtype, device)
        self.w_kr = param((d, dr), cfg.dtype, device)
        self.w_uk = param((r, H * dh), cfg.dtype, device)
        self.w_uv = param((r, H * dh), cfg.dtype, device)
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


def unflatten(t: torch.Tensor, *shape) -> torch.Tensor:
    """t (..., n * dh) reshaped to `shape` (..., n, dh).  Over a mesh (a
    DTensor) whose axes that split the flat dim do not divide the n heads,
    the flat dim is first replicated over them (the layout GSPMD gives
    such heads): a split that cuts inside a head cannot be reshaped."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(t, DTensor):
        last, pl = t.ndim - 1, list(t.placements)
        split = [i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == last]
        if split and shape[-2] % math.prod(t.device_mesh.shape[i]
                                           for i in split):
            for i in split:
                pl[i] = Replicate()
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(shape)


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for an output projection (w_o, w_down, out_proj, down_proj:
    rows over `model` by the rules).  Over a mesh that splits w's rows,
    each rank multiplies its own slice of x's last dim by its rows (their
    FSDP split gathered) in fp32, and the ranks' partial products are
    summed in fp32 and rounded to x's type once, as one device's GEMM
    accumulates (summed in a bf16 model's type, each partial would round
    on its own).  A local route: DTensor's own matmul rule flattens (B, S)
    and, where the batch does not divide the data axes, splits that
    flattened dim in a way its backward cannot undo.  On one device,
    x @ w."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(w, DTensor) and any(
            p == Shard(0) and n > 1
            for p, n in zip(w.placements, w.device_mesh.shape))):
        return x @ w
    mesh = w.device_mesh
    rows = [i for i, (p, n) in enumerate(zip(w.placements, mesh.shape))
            if p == Shard(0) and n > 1]
    xs = resolve(mesh, ("dp",) + (None,) * (x.ndim - 2) + ("tp",), x.shape)
    x = to_layout(x, mesh, xs)
    batch = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    if [i for i, p in enumerate(x.placements)
            if p == Shard(x.ndim - 1)] != rows:
        raise ValueError(f"x {x.placements} and w {w.placements} split "
                         "the contraction differently")
    w_pl = [Shard(0) if i in rows else Replicate()
            for i in range(mesh.ndim)]
    w_grad = [Shard(0) if i in rows else Partial() if i in batch
              else Replicate() for i in range(mesh.ndim)]
    wl = w.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    y = x.to_local().float() @ wl.float()
    out_pl = [Shard(0) if i in batch else Partial() if i in rows
              else Replicate() for i in range(mesh.ndim)]
    y = from_shard(y, mesh, out_pl, tuple(x.shape[:-1]) + (w.shape[1],))
    return constrain(y, *("dp",) + (None,) * (y.ndim - 1)).to(x.dtype)


def split_last(t: torch.Tensor, n: int) -> tuple:
    """t.chunk(n, dim=-1).  Over a mesh whose `model` axis alone splits t's
    last dim in tp contiguous blocks, each part comes out split the same
    way, by one all_to_all over `model`: the n * tp blocks of width w =
    N / (n * tp) are already whole on their ranks (rank i holds blocks
    i * n .. i * n + n - 1; block a * tp + j is part a's j-th), so each
    goes to its new rank as it is, the data GSPMD moves for `repro`'s
    split.  DTensor's own chunk of a split dim gathers t whole."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor) or "model" not in (
            t.device_mesh.mesh_dim_names or ()):
        return t.chunk(n, dim=-1)
    import torch.distributed._functional_collectives as funcol
    mesh, last = t.device_mesh, Shard(t.ndim - 1)
    mi = mesh.mesh_dim_names.index("model")
    tp = mesh.shape[mi]
    split = [i for i, p in enumerate(t.placements) if p == last]
    if tp == 1 or split != [mi] or t.shape[-1] % (n * tp):
        return t.chunk(n, dim=-1)
    i = mesh.get_local_rank("model")
    local = t.to_local()
    w = t.shape[-1] // (n * tp)
    blocks = local.reshape(local.shape[:-1] + (n, w)).movedim(-2, 0)
    # by new rank, then by part
    order = sorted(range(n), key=lambda q: ((i * n + q) % tp, q))
    send = blocks[torch.tensor(order, device=local.device)].contiguous()
    sizes_out = [sum(1 for q in range(n) if (i * n + q) % tp == j)
                 for j in range(tp)]
    sizes_in = [sum(1 for q in range(n) if (s * n + q) % tp == i)
                for s in range(tp)]
    got = funcol.all_to_all_single_autograd(send, sizes_in, sizes_out,
                                            mesh.get_group("model"))
    shape = tuple(t.shape[:-1]) + (t.shape[-1] // n,)
    return tuple(from_shard(got[a], mesh, t.placements, shape)
                 for a in range(n))


def elementwise(fn, t: torch.Tensor) -> torch.Tensor:
    """fn(t) for an elementwise fn.  Over a mesh (a DTensor) fn runs on
    each rank's shard, a partial sum first reduced (fn of a partial sum is
    not a partial of fn): DTensor has no rule for some such ops' backward
    (`log_sigmoid_backward`)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(t, DTensor):
        return fn(t)
    if any(isinstance(p, Partial) for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in t.placements])
    return from_shard(fn(t.to_local()), t.device_mesh, t.placements,
                      t.shape)


class _WholeLastDimGrad(torch.autograd.Function):
    """Identity whose gradient, over a mesh, has its last dim whole."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        last = Shard(g.ndim - 1)
        if isinstance(g, DTensor) and last in g.placements:
            g = g.redistribute(g.device_mesh, [
                Replicate() if p == last else p for p in g.placements])
        return g


def merge_heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """t (..., n, dh) reshaped to `shape` (..., n * dh): `unflatten`'s
    inverse.  Over a mesh the gradient reaching the merge has its last dim
    whole, so that its backward can split the heads again however few
    they are."""
    return _WholeLastDimGrad.apply(t.reshape(shape))


def split_heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """t (B, S, n * dh) as (B, S, n, dh), constrained ("dp", None, "tp",
    None)."""
    B, S, _ = t.shape
    return constrain(unflatten(t, B, S, n, dh), "dp", None, "tp", None)


def gqa_project_qkv(attn: GQA, x: torch.Tensor, cfg, rope: tuple):
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(x @ attn.w_q, H, dh)
    k = split_heads(x @ attn.w_k, Hk, dh)
    v = split_heads(x @ attn.w_v, Hk, dh)
    return apply_rope(q, rope), apply_rope(k, rope), v


def cross_project_q(cross: CrossAttention, x: torch.Tensor, cfg):
    """Cross-attention queries (B, S, H, dh), with no rotary embedding, as
    `repro`'s `_apply_cross_attn` applies none."""
    B, S, _ = x.shape
    return unflatten(x @ cross.w_q, B, S, cfg.num_heads, cfg.head_dim)


def cross_project_kv(cross: CrossAttention, enc_out: torch.Tensor, cfg):
    """Cross-attention keys and values (B, S_src, Hk, dh) of the encoder's
    output, with no rotary embedding."""
    B, S, _ = enc_out.shape
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    return (unflatten(enc_out @ cross.w_k, *shape),
            unflatten(enc_out @ cross.w_v, *shape))


def mla_latent(attn: MLA, x: torch.Tensor, cfg, rope: tuple):
    """What the MLA decode cache stores for x (B, S, d): the latent c_kv
    (B, S, r) and the rotary key (B, S, 1, dr), rotated (`rope` is
    `rope_table` at width dr) and cast back to the model type."""
    B, S, _ = x.shape
    c_kv = x @ attn.w_dkv
    k_rope = unflatten(x @ attn.w_kr, B, S, 1, cfg.rope_head_dim)
    return c_kv, apply_rope(k_rope, rope)


def mla_expand(attn: MLA, c_kv: torch.Tensor, k_rope: torch.Tensor, cfg):
    """Keys (B, Skv, H, dh + dr), [k_nope | k_rope] with the rotary key
    broadcast over the heads after its cast, and values (B, Skv, H, dh),
    each up-projected from the latent in the model type."""
    B, Skv, _ = c_kv.shape
    H, dh, dr = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    k_nope = unflatten(c_kv @ attn.w_uk, B, Skv, H, dh)
    v = unflatten(c_kv @ attn.w_uv, B, Skv, H, dh)
    k = torch.cat([k_nope, k_rope.expand(B, Skv, H, dr)], dim=-1)
    return k, v


def mla_attend(attn: MLA, x: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, cfg, rope: tuple, attend=None, **kw):
    """MLA attention of the queries of x (B, Sq, d) against the latents
    (c_kv, k_rope) of Skv positions, through `attend(q, k, v, **kw)`
    (`attention` by default; a kernel through `pad_v`), then the output
    projection: (B, Sq, d).  Queries are [q_nope | q_rope], q_rope rotated
    in fp32 and cast; the scale is (dh + dr)**-0.5, q's width, as in
    `repro`."""
    B, Sq, _ = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    q = unflatten(x @ attn.w_q, B, Sq, H, dh + cfg.rope_head_dim)
    q = torch.cat([q[..., :dh], apply_rope(q[..., dh:], rope)], dim=-1)
    k, v = mla_expand(attn, c_kv, k_rope, cfg)
    o = (attend or attention)(q, k, v, **kw)
    return row_parallel(o.reshape(B, Sq, H * dh), attn.w_o)


def pad_v(attend):
    """`attend` (a kernel's entry point, which takes q, k and v of one
    width) for values narrower than the queries: v is zero-padded to q's
    width and the output cut back to v's.  The padded columns of the
    output are zero and the rest unchanged, since the kernels scale by
    q's width.  Pad v only: padding q or k would change that scale."""
    def run(q, k, v, *args, **kw):
        dv = v.shape[-1]
        v = F.pad(v, (0, q.shape[-1] - dv))
        return attend(q, k, v, *args, **kw)[..., :dv]
    return run


def repeat_kv(k: torch.Tensor, G: int) -> torch.Tensor:
    """(B,S,Hk,dh) -> (B,S,Hk*G,dh), each KV head repeated for its G query
    heads."""
    return torch.repeat_interleave(k, G, dim=2) if G > 1 else k


def chunked(Sq: int, Skv: int, force: bool = False) -> bool:
    """`repro`'s dispatch (`layers.py:115-116`): stream KV chunks when asked
    or past `_MATERIALIZE_LIMIT` scores a head, for more than one query,
    and only at sizes the chunks divide (else stay materialised)."""
    return ((force or Sq * Skv > _MATERIALIZE_LIMIT) and Sq > 1
            and Sq % _CHUNK_Q == 0 and Skv % _CHUNK_K == 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None,
              force_chunked: bool = False) -> torch.Tensor:
    """`repro`'s GQA attention, under autograd (the train forward; `repro`
    ran no Pallas kernel there): `attention_chunked` where `chunked` says,
    else materialised.  q: (B,Sq,H,dh); k, v: (B,Skv,Hk,dh).  Query row i
    sees keys j <= i (causal) and j > i - window.  Its rounding points: q
    scaled by dh**-0.5 (itself rounded to the model type) in the model
    type, scores accumulated in fp32 and capped there (`softcap`), the
    softmax in fp32, probs cast to v's type, P.V accumulated in fp32 and
    cast to q's type.  v may be narrower than q and k (MLA).  Returns
    (B,Sq,H,v's width)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        # each rank attends over its own batch rows and heads: DTensor's
        # rule for these einsums flattens a split dim on some torch
        from repro_torch.kernels.ops import _local_heads
        return _local_heads(lambda ql, kl, vl: attention(
            ql, kl, vl, causal=causal, window=window, softcap=softcap,
            force_chunked=force_chunked), q, k, v)
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    if chunked(Sq, Skv, force_chunked):
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    G = H // k.shape[2]
    k, v = repeat_kv(k, G), repeat_kv(v, G)
    # the scale rounded to q's type first, as JAX's weak float is
    scale = torch.tensor(dh ** -0.5, dtype=q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    scores = cap_scores(scores, softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset=0, kv_len=None, softcap: float | None = None,
                      chunk_q: int = _CHUNK_Q,
                      chunk_k: int = _CHUNK_K) -> torch.Tensor:
    """`repro`'s `attention_chunked`: for each query chunk an online softmax
    over KV chunks, never more than (B, H, chunk_q, chunk_k) scores, each
    KV chunk's body recomputed in the backward (`recompute`, `repro`'s
    `jax.checkpoint(kv_body)`).  q: (B,Sq,H,dh); k, v: (B,Skv,Hk,dh), v
    possibly narrower (MLA); Sq and Skv multiples of the chunks.  q_offset
    is query row 0's position, kv_len the keys visible (a scalar).  Its
    rounding points: q scaled in the model type, scores and the running
    max m, sum l and output acc in fp32, p cast to v's type before P.V,
    acc / max(l, 1e-30) cast to q's type.

    A row whose first chunks are all masked gathers finite garbage there
    (every score NEG_INF, so p = 1), which its first visible chunk wipes
    to exactly 0 (corr = exp(NEG_INF - m) = 0); a masked chunk after a
    visible one adds exactly 0.  So the chunks that the masks hide from
    every row of a query chunk are not computed (`_visible_chunks`), which
    gives the same bits as computing them (tested), as long as every row
    of that query chunk sees some key; where one does not, or q_offset or
    kv_len lives on the device, every chunk is computed, as in `repro`."""
    B, Sq, H, dh = q.shape
    Skv, dv = k.shape[1], v.shape[-1]
    G = H // k.shape[2]
    k, v = repeat_kv(k, G), repeat_kv(v, G)
    scale = torch.tensor(dh ** -0.5, dtype=q.dtype)
    qs = q * scale
    arange_q = torch.arange(chunk_q, device=q.device)
    visible = _visible_chunks(causal, window, q_offset, kv_len, Skv)
    outs = []
    for qi in range(Sq // chunk_q):
        rows = slice(qi * chunk_q, (qi + 1) * chunk_q)
        qp = q_offset + qi * chunk_q + arange_q
        m = torch.full((B, H, chunk_q), -math.inf, device=q.device)
        l = torch.zeros((B, H, chunk_q), device=q.device)
        acc = torch.zeros((B, H, chunk_q, dv), device=q.device)
        for ki in range(Skv // chunk_k):
            k0 = ki * chunk_k
            if visible is not None and not visible(qi * chunk_q, chunk_q,
                                                   k0, chunk_k):
                continue
            cols = slice(k0, k0 + chunk_k)
            m, l, acc = recompute(
                _kv_chunk, qs[:, rows], k[:, cols], v[:, cols], m, l, acc,
                qp, k0, causal, window, kv_len, softcap)
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,H,cq,dv)
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def _kv_chunk(q_blk, k_blk, v_blk, m, l, acc, qp, k0: int, causal: bool,
              window, kv_len, softcap):
    """One KV chunk's step of the online softmax: (m, l, acc) updated."""
    s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), k_blk.float())
    s = cap_scores(s, softcap)
    kp = k0 + torch.arange(k_blk.shape[1], device=s.device)
    mask = torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool,
                      device=s.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    if kv_len is not None:
        mask &= kp[None, :] < kv_len
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l, acc


def _visible_chunks(causal: bool, window, q_offset, kv_len, Skv: int):
    """A test (q0, cq, k0, ck) -> whether any query of positions
    [q0, q0 + cq) (plus q_offset) sees a key in [k0, k0 + ck); it answers
    True for every chunk of a query chunk with a row that sees no key.
    None where the positions or lengths live on the device."""
    if isinstance(q_offset, torch.Tensor) or isinstance(kv_len,
                                                        torch.Tensor):
        return None
    last = Skv if kv_len is None else min(int(kv_len), Skv)

    def keys(p: int) -> tuple[int, int]:
        lo = 0 if window is None else max(0, p - window + 1)
        hi = min(p if causal else Skv - 1, last - 1)
        return lo, hi

    def test(q0: int, cq: int, k0: int, ck: int) -> bool:
        (lo0, hi0), (lo1, hi1) = keys(q_offset + q0), keys(
            q_offset + q0 + cq - 1)
        if lo0 > hi0 or lo1 > hi1:      # a row that sees nothing (the ends
            return True                 # are the rows that can): no skip
        # rows' key ranges move up by at most one a row: their union is
        # [lo0, hi1]
        return k0 <= hi1 and k0 + ck - 1 >= lo0
    return test


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(x, approximate=True)`'s own formula, op by op in x's type
    with its constants rounded to that type first: cdf = 0.5 * (1 +
    tanh(sqrt(2/pi) * (x + 0.044715 * x**3))), then x * cdf.
    `F.gelu(approximate="tanh")` rounds once, which in bf16 moves values by
    an ulp."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`'s own formula, x * (1 / (1 + exp(-x))), op by op in x's
    type, the gate of every SiLU FFN (dense, expert, shared) and the
    mLSTM's and Mamba's.  `F.silu` rounds once; in bf16 that moves values
    by an ulp, which the layers after amplify past the bf16 limit (jamba's
    SMOKE model: half of a dense layer's outputs an ulp apart)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


ACTS = {"silu": silu, "gelu": gelu, "relu": F.relu}


def ffn(params: FFN, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """GLU: act(x @ w_gate) * (x @ w_up) @ w_down, act a key of ACTS."""
    g = ACTS[act](constrain(x @ params.w_gate, "dp", None, "tp"))
    u = constrain(x @ params.w_up, "dp", None, "tp")
    return row_parallel(g * u, params.w_down)


def write_rows(cache: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
               new: torch.Tensor) -> None:
    """cache[rows, slot] = new, in place: cache (B, S, ...), rows and slot
    (B,), new (B, ...).  Over a mesh (a DTensor cache) each rank writes
    its own batch rows, and over a cache split along its sequence only the
    rank that holds row `slot` writes it; no rank gathers the cache."""
    from torch.distributed.tensor import DTensor
    if not isinstance(cache, DTensor):
        cache[rows, slot] = new
        return
    from repro_torch.sharding.rules import spec_of
    mesh = cache.device_mesh
    spec = spec_of(cache)
    cl = cache.to_local()
    nl = to_layout(new, mesh, spec[:1] + spec[2:]).to_local()
    Bl, Sl = cl.shape[0], cl.shape[1]
    if spec[0] is not None:
        bi = axis_index(mesh, spec[0])
        slot = slot[bi * Bl:(bi + 1) * Bl]
    idx = slot
    if spec[1] is not None:
        si = axis_index(mesh, spec[1])
        idx = slot - si * Sl
    own = (idx >= 0) & (idx < Sl)
    safe = torch.clamp(idx, 0, Sl - 1)
    local_rows = torch.arange(Bl, device=cl.device)
    keep = own.reshape(-1, *([1] * (nl.dim() - 1)))
    cl[local_rows, safe] = torch.where(keep, nl, cl[local_rows, safe])


def write_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """cache[:, :, :n] = new (n = new.shape[2]) in place: cache (R, B, S,
    ...), the sequence at dim 2.  Over a mesh (a DTensor cache) each rank
    copies the rows of its own slice of the sequence, from `new` in the
    cache's layout with its sequence whole."""
    from torch.distributed.tensor import DTensor
    n = new.shape[2]
    if not isinstance(cache, DTensor):
        cache[:, :, :n].copy_(new)
        return
    from repro_torch.sharding.rules import spec_of
    mesh = cache.device_mesh
    spec = spec_of(cache)
    nl = to_layout(new, mesh, spec[:2] + (None,) + spec[3:]).to_local()
    cl = cache.to_local()
    Sl = cl.shape[2]
    lo = 0
    if spec[2] is not None:
        lo = axis_index(mesh, spec[2]) * Sl
    hi = min(lo + Sl, n)
    if hi > lo:
        cl[:, :, :hi - lo].copy_(nl[:, :, lo:hi])


def live_rows(live: int, *caches: torch.Tensor) -> tuple:
    """Each cache[:, :live] (a view): the rows a decode step can read.
    Where any of them is split along its sequence over a mesh, all are
    passed whole (the kernel reads each rank's rows below kv_len): cutting
    a split cache would gather it."""
    from torch.distributed.tensor import DTensor, Shard
    if any(isinstance(c, DTensor) and Shard(1) in c.placements
           for c in caches):
        return caches
    return tuple(c[:, :live] for c in caches)
