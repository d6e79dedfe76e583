"""Plain fp32 reference of a GQA decoder with a dense SiLU FFN and a
sliding window (h2o-danube-1.8b), its next-token loss and AdamW.  Plain torch operations only; it imports nothing of the
program under test.

`leaves(m)` names every weight with its shape, type and the spread it is
drawn with, in the program's parameter names (the benchmark draws them once
and hands the same values to both sides).  `forward` runs whole sequences
position by position in fp32, layer by layer; the decode check runs one
row at a time, so a few GiB at most are alive.

Departures from the published models, each the port's model's, followed
here so that both sides compute one function:
  * the embedding is scaled by sqrt(d_model) and the queries by
    head_dim**-0.5, each constant rounded to the served type first;
    published danube (llama style) scales the queries alone, unrounded;
  * RMSNorm's epsilon is 1e-6 (published 1e-5), and the vocabulary is
    padded to a multiple of `vocab_pad_multiple`, the padded columns left
    out of the logits.

`decode_step_work` and `train_step_work` give a step's model FLOPs and
each kernel call's least time at the card's peaks, by kernel name, from
`muxbench/work.py`'s counts for this architecture; the sides and the
metric readers take them from here, so that another architecture brings
its own counts in its own reference file.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from muxbench import work

NORM_EPS = 1e-6


def padded_vocab(m: dict) -> int:
    k = m["vocab_pad_multiple"]
    return (m["vocab_size"] + k - 1) // k * k


def leaves(m: dict) -> list[tuple[str, tuple, str, float | None]]:
    """(name, shape, type, std) of every weight, in the program's order;
    std None means the constant 1 (a norm's scale).  Projections are drawn
    N(0, 1/fan_in), the embedding N(0, 0.02**2)."""
    d, V = m["d_model"], padded_vocab(m)
    H, Hk, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    out = [("embed", (V, d), "model", 0.02)]
    for l in range(m["num_layers"]):
        p = f"blocks.{l}."
        out += [(p + "norm1.scale", (d,), "model", None),
                (p + "attn.w_q", (d, H * dh), "model", d ** -0.5),
                (p + "attn.w_k", (d, Hk * dh), "model", d ** -0.5),
                (p + "attn.w_v", (d, Hk * dh), "model", d ** -0.5),
                (p + "attn.w_o", (H * dh, d), "model", (H * dh) ** -0.5),
                (p + "norm2.scale", (d,), "model", None)]
        f = m["d_ff"]
        out += [(p + "ffn.w_gate", (d, f), "model", d ** -0.5),
                (p + "ffn.w_up", (d, f), "model", d ** -0.5),
                (p + "ffn.w_down", (f, d), "model", f ** -0.5)]
    out += [("final_norm.scale", (d,), "model", None),
            ("lm_head", (d, V), "model", d ** -0.5)]
    return out


def served_constant(x: float, served: torch.dtype) -> float:
    """x rounded to the served type, as the port's model rounds its
    constants."""
    return float(torch.tensor(x, dtype=served))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + NORM_EPS) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, dh) rotated at positions pos (S,): the two halves of
    the head as the real and imaginary parts."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float32) / dh)
    ang = pos[:, None].float() * inv                      # (S, dh/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, scale: float, window: int | None,
              block: int = 1024) -> torch.Tensor:
    """Causal attention, query i seeing keys i - window < j <= i; q (B, S,
    H, dh), k and v (B, S, Hk, dh); queries in blocks of `block` rows."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    kp = torch.arange(S, device=q.device)
    outs = []
    for q0 in range(0, S, block):
        qb = q[:, q0:q0 + block] * scale
        qp = torch.arange(q0, q0 + qb.shape[1], device=q.device)[:, None]
        s = torch.einsum("bqhd,bkhd->bhqk", qb, k)
        mask = kp[None] <= qp
        if window is not None:
            mask &= kp[None] > qp - window
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v))
    return torch.cat(outs, dim=1)


def forward(w: dict, m: dict, tokens: torch.Tensor, *, served: torch.dtype,
            logits_from: int = 0, mm=torch.matmul) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S - logits_from, vocab_size) of the
    positions from `logits_from` on.  `mm` is every projection's product
    (the control puts a lower precision there).  Under autograd each layer
    is recomputed in the backward, so that one layer's activations are
    alive at a time."""
    B, S = tokens.shape
    H, Hk, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    pos = torch.arange(S, device=tokens.device)
    scale = served_constant(dh ** -0.5, served)

    def layer(x, p):
        h = rmsnorm(x, w[p + "norm1.scale"])
        q = mm(h, w[p + "attn.w_q"]).reshape(B, S, H, dh)
        k = mm(h, w[p + "attn.w_k"]).reshape(B, S, Hk, dh)
        v = mm(h, w[p + "attn.w_v"]).reshape(B, S, Hk, dh)
        q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
        o = attention(q, k, v, scale, m.get("window"))
        x = x + mm(o.reshape(B, S, H * dh), w[p + "attn.w_o"])
        h = rmsnorm(x, w[p + "norm2.scale"])
        return x + mm(F.silu(mm(h, w[p + "ffn.w_gate"]))
                      * mm(h, w[p + "ffn.w_up"]), w[p + "ffn.w_down"])

    x = w["embed"][tokens] * served_constant(math.sqrt(m["d_model"]), served)
    for l in range(m["num_layers"]):
        if torch.is_grad_enabled():
            x = checkpoint(layer, x, f"blocks.{l}.", use_reentrant=False)
        else:
            x = layer(x, f"blocks.{l}.")
    x = rmsnorm(x[:, logits_from:], w["final_norm.scale"])
    return mm(x, w["lm_head"][:, :m["vocab_size"]])


def loss(w: dict, m: dict, tokens: torch.Tensor, *, served: torch.dtype,
         mm=torch.matmul) -> torch.Tensor:
    """Next-token cross-entropy over every position but the last."""
    logits = forward(w, m, tokens, served=served, mm=mm)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tokens.roll(-1, dims=1)[..., None])[..., 0]
    return nll[:, :-1].mean()


def lr_at(h: dict, step: int) -> float:
    """Linear warm-up to lr over warmup_steps, then a cosine to
    min_lr_frac * lr at total_steps."""
    if step < h["warmup_steps"]:
        return h["lr"] * step / max(h["warmup_steps"], 1)
    prog = min(max((step - h["warmup_steps"])
                   / max(h["total_steps"] - h["warmup_steps"], 1), 0.0), 1.0)
    lo = h["min_lr_frac"] * h["lr"]
    return lo + (h["lr"] - lo) * 0.5 * (1 + math.cos(math.pi * prog))


@torch.no_grad()
def adamw_step(params: list, grads: list, state: dict, h: dict):
    """One AdamW step in place: the gradients clipped to a global norm of
    grad_clip, decoupled weight decay on every weight.  Returns the global
    norm before clipping and the clipped gradients."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    c = torch.clamp(h["grad_clip"] / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(c)
    t = state["step"] = state.get("step", 0) + 1
    b1, b2 = h["b1"], h["b2"]
    if "m" not in state:
        state["m"] = [torch.zeros_like(p) for p in params]
        state["v"] = [torch.zeros_like(p) for p in params]
    for p, g, mo, v in zip(params, grads, state["m"], state["v"]):
        mo.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(adamw_update(p, mo, v, t, h))
    return gnorm, grads


def adamw_update(p, mo, v, t: int, h: dict):
    """The change AdamW takes off the weight p at step t (counted from 1)
    from its moments mo and v after that step."""
    upd = (mo / (1 - h["b1"] ** t)) / ((v / (1 - h["b2"] ** t)).sqrt()
                                       + h["eps"])
    return lr_at(h, t) * (upd + h["weight_decay"] * p)


def decode_step_work(m: dict, batch: int, pos: int, dtype: str) -> dict:
    """One decode step of `batch` rows at position `pos`: its model FLOPs
    and, under "least_s", the least seconds of its decode-attention calls
    (every layer's; bytes and operations at the peaks)."""
    kv = work.visible_keys(pos, m)
    ms, _ = work.bound(
        work.decode_attention_bytes(m, batch, kv, dtype),
        {"mm": (work.decode_attention_flops(m, batch, kv),
                work.PEAK_FLOPS[dtype])})
    return {"flops": work.decode_step_flops(m, batch, pos),
            "least_s": {"decode_attention": m["num_layers"] * ms / 1e3}}


def train_step_work(m: dict, batch: int, seq: int, dtype: str) -> dict:
    """One train step of `batch` x `seq` tokens: its model FLOPs."""
    return {"flops": work.train_step_flops(m, batch, seq), "least_s": {}}
