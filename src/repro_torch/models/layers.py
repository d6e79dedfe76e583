"""Core model layers: RMSNorm, RoPE, GQA projections, cross-attention's
projections, MLA (multi-head latent attention: the latent, its expansion to
keys and values, and its attention), the train forward's attention, the
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

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# above this many scores a head `repro` streams over KV chunks
# (`attention_chunked`), which is not ported
_MATERIALIZE_LIMIT = 4096 * 4096
_CHUNK_Q = _CHUNK_K = 2048


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


def gqa_project_qkv(attn: GQA, x: torch.Tensor, cfg, rope: tuple):
    B, S, _ = x.shape
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ attn.w_q).reshape(B, S, H, dh)
    k = (x @ attn.w_k).reshape(B, S, Hk, dh)
    v = (x @ attn.w_v).reshape(B, S, Hk, dh)
    return apply_rope(q, rope), apply_rope(k, rope), v


def cross_project_q(cross: CrossAttention, x: torch.Tensor, cfg):
    """Cross-attention queries (B, S, H, dh), with no rotary embedding, as
    `repro`'s `_apply_cross_attn` applies none."""
    B, S, _ = x.shape
    return (x @ cross.w_q).reshape(B, S, cfg.num_heads, cfg.head_dim)


def cross_project_kv(cross: CrossAttention, enc_out: torch.Tensor, cfg):
    """Cross-attention keys and values (B, S_src, Hk, dh) of the encoder's
    output, with no rotary embedding."""
    B, S, _ = enc_out.shape
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    return ((enc_out @ cross.w_k).reshape(shape),
            (enc_out @ cross.w_v).reshape(shape))


def mla_latent(attn: MLA, x: torch.Tensor, cfg, rope: tuple):
    """What the MLA decode cache stores for x (B, S, d): the latent c_kv
    (B, S, r) and the rotary key (B, S, 1, dr), rotated (`rope` is
    `rope_table` at width dr) and cast back to the model type."""
    B, S, _ = x.shape
    c_kv = x @ attn.w_dkv
    k_rope = (x @ attn.w_kr).reshape(B, S, 1, cfg.rope_head_dim)
    return c_kv, apply_rope(k_rope, rope)


def mla_expand(attn: MLA, c_kv: torch.Tensor, k_rope: torch.Tensor, cfg):
    """Keys (B, Skv, H, dh + dr), [k_nope | k_rope] with the rotary key
    broadcast over the heads after its cast, and values (B, Skv, H, dh),
    each up-projected from the latent in the model type."""
    B, Skv, _ = c_kv.shape
    H, dh, dr = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    k_nope = (c_kv @ attn.w_uk).reshape(B, Skv, H, dh)
    v = (c_kv @ attn.w_uv).reshape(B, Skv, H, dh)
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
    q = (x @ attn.w_q).reshape(B, Sq, H, dh + cfg.rope_head_dim)
    q = torch.cat([q[..., :dh], apply_rope(q[..., dh:], rope)], dim=-1)
    k, v = mla_expand(attn, c_kv, k_rope, cfg)
    o = (attend or attention)(q, k, v, **kw)
    return o.reshape(B, Sq, H * dh) @ attn.w_o


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """`repro`'s materialised GQA attention, under autograd (the train
    forward; `repro` ran no Pallas kernel there).  q: (B,Sq,H,dh); k, v:
    (B,Skv,Hk,dh).  Query row i sees keys j <= i (causal) and j > i - window.
    Its rounding points: q scaled by dh**-0.5 (itself rounded to the model
    type) in the model type, scores
    accumulated in fp32, the softmax in fp32, probs cast to v's type, P.V
    accumulated in fp32 and cast to q's type.  v may be narrower than q and
    k (MLA).  Returns (B,Sq,H,v's width)."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    if (Sq * Skv > _MATERIALIZE_LIMIT and Sq > 1 and Sq % _CHUNK_Q == 0
            and Skv % _CHUNK_K == 0):
        raise NotImplementedError(
            f"attention at Sq={Sq}, Skv={Skv}: `repro` streams KV chunks "
            "there (attention_chunked), which is not ported; see ROADMAP.md")
    G = H // k.shape[2]
    k, v = repeat_kv(k, G), repeat_kv(v, G)
    # the scale rounded to q's type first, as JAX's weak float is
    scale = torch.tensor(dh ** -0.5, dtype=q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
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
    return (ACTS[act](x @ params.w_gate) * (x @ params.w_up)) @ params.w_down
