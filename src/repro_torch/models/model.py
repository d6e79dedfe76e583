"""Model core for the port: config, init, caches and the forward pass.

Two patterns are ported, each in every mode `repro` runs it in:
  * dense GQA `(("attn", "dense"),)`, full or sliding-window attention, with
    a SiLU or GELU FFN;
  * mLSTM `(("mlstm", "none"),)`.
Modes: `train` (full-sequence logits, the offline train step), `prefill`
(the prompt's pass: last-token logits and the decode cache) and `decode`
(one token against the cache, the online-serving hot path).  Prefill
attention is `kernels.ops.flash_attention` and decode attention
`kernels.ops.decode_attention`; the train forward keeps `repro`'s
materialised attention under autograd, and the mLSTM runs no kernel.

Blocks are an `nn.ModuleList` of per-layer modules, run by a Python loop; the
cache keeps `repro`'s layout, a tuple over pattern positions of {"k", "v"}
(dense) or {"C", "n", "m", "conv"} (mLSTM) tensors with a leading `repeats`
dimension.  A sliding-window model's cache holds min(window, capacity)
rows; at `window` rows it is `repro`'s ring.

`repro` wrapped the train forward's layer scan in `jax.checkpoint` (remat),
which only trades recomputation for activation memory; the port keeps
autograd's saved activations instead.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import kv_lengths

from . import layers as L
from . import ssm as S

DENSE_PATTERN = (("attn", "dense"),)
MLSTM_PATTERN = (("mlstm", "none"),)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple = DENSE_PATTERN
    window: int | None = None         # sliding window (None = full)
    rope_theta: float = 10000.0
    ffn_act: str = "silu"
    # mlstm
    ssm_conv_dim: int = 4
    ssm_chunk: int = 256
    mlstm_proj_factor: int = 2
    dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 256

    def __post_init__(self):
        dense = self.pattern == DENSE_PATTERN and self.ffn_act in L.ACTS
        if not (dense or self.pattern == MLSTM_PATTERN):
            raise NotImplementedError(
                f"{self.name}: only the dense pattern {DENSE_PATTERN} (full "
                f"or sliding-window attention) with an FFN gate in {tuple(L.ACTS)} "
                f"and the mLSTM pattern {MLSTM_PATTERN} are ported; see "
                "ROADMAP.md")

    @property
    def repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    def param_count(self) -> int:
        """Analytic parameter count, `repro`'s formula for the ported
        patterns (the profiling catalog's cost model reads it)."""
        d = self.d_model
        if self.pattern == MLSTM_PATTERN:
            dp = self.mlstm_proj_factor * d
            block = (d + d * 2 * dp + self.ssm_conv_dim * dp + 3 * dp * dp
                     + 2 * dp * self.num_heads + dp + dp * d
                     + dp + 2 * self.num_heads)  # conv_b, b_i, b_f
        else:
            H, Hk, dh = self.num_heads, self.num_kv_heads, self.head_dim
            block = (d + d * dh * (H + 2 * Hk) + H * dh * d
                     + d + 3 * d * self.d_ff)
        return 2 * self.padded_vocab * d + block * self.repeats + d


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = L.GQA(cfg, device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.dtype, device)
        self.ffn = L.FFN(cfg.d_model, cfg.d_ff, cfg.dtype, device)


class MLSTMBlock(nn.Module):
    """An `("mlstm", "none")` block: pre-norm mLSTM, no FFN (the block's
    up-projection is its FFN)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mixer = S.MLSTM(cfg, device)


class Transformer(nn.Module):
    """Parameters (uninitialised) on `device`; names follow `repro`'s tree,
    with `blocks.<layer>` in place of the stacked `blocks[0]`."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, V = cfg.d_model, cfg.padded_vocab
        self.embed = L.param((V, d), cfg.dtype, device)
        block = MLSTMBlock if cfg.pattern == MLSTM_PATTERN else Block
        self.blocks = nn.ModuleList(block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(d, cfg.dtype, device)
        self.lm_head = L.param((d, V), cfg.dtype, device)


# constant initial values and fixed init scales of `repro`'s mlstm_init
_CONST_INIT = {"conv_b": 0.0, "b_i": 0.0, "b_f": 3.0}   # open forget gates
_INIT_STD = {"conv_w": 0.5, "w_i": 0.02, "w_f": 0.02}


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random weights on the generator's device, drawn as `repro` draws them:
    embedding N(0, 0.02), projections truncated normal (+-2 std) with
    std 1/sqrt(fan_in) unless `repro` fixes the scale, norm scales 1, mLSTM
    gate biases constant.  Drawn in fp32, stored in each parameter's type."""
    model = Transformer(cfg, generator.device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("scale"):
                p.fill_(1.0)
                continue
            if leaf in _CONST_INIT:
                p.fill_(_CONST_INIT[leaf])
                continue
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name == "embed":
                w.normal_(0.0, 0.02, generator=generator)
            else:
                std = _INIT_STD.get(leaf, 1.0 / math.sqrt(p.shape[0]))
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            p.copy_(w)
    return model


def init_cache(cfg: ModelConfig, batch: int, kv_capacity: int,
               device=None) -> tuple:
    """Decode cache, a tuple over pattern positions, each leaf with a leading
    `repeats` dimension.  Dense: {"k", "v"}, each (repeats, batch, cap, Hk,
    head_dim) zeros in cfg.dtype, where cap is kv_capacity, or
    min(window, kv_capacity) for a sliding window (the ring's bound).
    mLSTM: {"C", "n", "m"} in fp32 (m at -60) and "conv" in cfg.dtype, the
    shapes of `ssm.mlstm_state_init`; kv_capacity does not apply."""
    dev = resolve_device(device)
    R = cfg.repeats
    if cfg.pattern == MLSTM_PATTERN:
        st = S.mlstm_state_init(batch, cfg, dev)
        (C, n, m), conv = st["carry"], st["conv"]
        return ({"C": C.expand(R, *C.shape).clone(),
                 "n": n.expand(R, *n.shape).clone(),
                 "m": m.expand(R, *m.shape).clone(),
                 "conv": conv.expand(R, *conv.shape).clone()},)
    cap = (kv_capacity if cfg.window is None
           else min(cfg.window, kv_capacity))
    shape = (R, batch, cap, cfg.num_kv_heads, cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                  "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
                 for _ in cfg.pattern)


def _embed(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor):
    # the scale is rounded to the model dtype first, as JAX's weak float is
    return params.embed[tokens] * torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=cfg.dtype)


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            mode: str = "decode", cache: tuple | None = None, pos=None):
    """decode: batch={"tokens": (B, 1)}, cache, pos (int or (B,); the mLSTM
    ignores it) -> (logits (B, Vpad), cache).
    prefill: batch={"tokens": (B, S)} -> (logits of the last position
    (B, Vpad), a new cache of S rows (or the window's, ring-aligned), aux).
    train: batch={"tokens": (B, S)} -> (logits (B, S, Vpad), aux).
    aux is a zero scalar (no MoE).

    In decode the cache is updated in place: `repro` wrote a new cache
    functionally, which at full width would copy every layer's cache on
    every step.  The returned cache is the object passed in."""
    mlstm = cfg.pattern == MLSTM_PATTERN
    if mode == "train":
        return (_forward_train_mlstm if mlstm
                else _forward_train_dense)(params, cfg, batch)
    if mode == "prefill":
        return (_forward_prefill_mlstm if mlstm
                else _forward_prefill_dense)(params, cfg, batch)
    if mode != "decode" or cache is None:
        raise NotImplementedError(
            f"mode={mode!r}: the port runs train, prefill, and decode "
            "against a cache; see ROADMAP.md")
    if mlstm:
        return _forward_decode_mlstm(params, cfg, batch, cache)
    return _forward_decode_dense(params, cfg, batch, cache, pos)


def _forward_decode_dense(params: Transformer, cfg: ModelConfig, batch: dict,
                          cache: tuple, pos):
    dev = params.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    B = tokens.shape[0]
    H, dh = cfg.num_heads, cfg.head_dim
    kc_all, vc_all = cache[0]["k"], cache[0]["v"]
    cap = kc_all.shape[2]
    # `repro`'s ring: a sliding-window cache of exactly `window` rows, written
    # at slot pos % window.  Its valid slots are the first min(pos + 1, W)
    # (the softmax does not depend on their order), so the kernel reads them
    # with kv_len = min(pos + 1, W); rotary angles keep the absolute position.
    ring = cfg.window is not None and cap == cfg.window
    # kv_len is checked against the capacity once, on the host; a pos on the
    # card is copied there first (one wait for the card), so that a position
    # past the cache raises instead of being clamped by the kernel
    host_pos = torch.as_tensor(pos).cpu().long().reshape(-1).expand(B)
    host_lens = host_pos + 1
    if ring:
        host_lens = torch.clamp(host_lens, max=cap)
    host_lens = kv_lengths(host_lens, B, cap, torch.device("cpu"))
    # one copy to the card: the positions and the lengths side by side
    pos_lens = torch.stack([host_pos.int(), host_lens]).to(dev)
    pos_b, lens = pos_lens[0].long(), pos_lens[1]              # (B,) each
    # attention reads the caches cut to the longest live sequence (a view):
    # no row past it is visible, and the kernel sizes its split from it
    live = int(host_lens.max())
    slot = pos_b % cap if ring else pos_b
    rope = L.rope_table(pos_b[:, None], dh, cfg.rope_theta)
    rows = torch.arange(B, device=dev)

    x = _embed(params, cfg, tokens)
    for r, blk in enumerate(params.blocks):
        h = L.rmsnorm(blk.norm1, x)
        q, k, v = L.gqa_project_qkv(blk.attn, h, cfg, rope)
        kc, vc = kc_all[r], vc_all[r]
        kc[rows, slot] = k[:, 0]
        vc[rows, slot] = v[:, 0]
        # every Sq == 1 attention takes the decode kernel, MHA included
        # (`repro` sent MHA down its dense path: the same function)
        o = ops.decode_attention(q, kc[:, :live], vc[:, :live], lens)
        x = x + o.reshape(B, 1, H * dh) @ blk.attn.w_o
        h = L.rmsnorm(blk.norm2, x)
        x = x + L.ffn(blk.ffn, h, cfg.ffn_act)
    x = L.rmsnorm(params.final_norm, x)
    return x[:, 0] @ params.lm_head, cache


def _forward_train_dense(params: Transformer, cfg: ModelConfig, batch: dict):
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    rope = L.rope_table(positions[None], cfg.head_dim, cfg.rope_theta)
    x = _embed(params, cfg, tokens)
    for blk in params.blocks:
        h = L.rmsnorm(blk.norm1, x)
        q, k, v = L.gqa_project_qkv(blk.attn, h, cfg, rope)
        o = L.attention(q, k, v, causal=True, window=cfg.window)
        x = x + o.reshape(B, S, cfg.num_heads * cfg.head_dim) @ blk.attn.w_o
        h = L.rmsnorm(blk.norm2, x)
        x = x + L.ffn(blk.ffn, h, cfg.ffn_act)
    x = L.rmsnorm(params.final_norm, x)
    return x @ params.lm_head, torch.zeros((), device=x.device)


def _forward_train_mlstm(params: Transformer, cfg: ModelConfig, batch: dict):
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    x = _embed(params, cfg, tokens)
    for blk in params.blocks:
        h = L.rmsnorm(blk.norm1, x)
        o, _ = S.mlstm_mixer(blk.mixer, h, cfg)
        x = x + o
    x = L.rmsnorm(params.final_norm, x)
    return x @ params.lm_head, torch.zeros((), device=x.device)


def _forward_decode_mlstm(params: Transformer, cfg: ModelConfig, batch: dict,
                          cache: tuple):
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    c = cache[0]
    x = _embed(params, cfg, tokens)
    for r, blk in enumerate(params.blocks):
        h = L.rmsnorm(blk.norm1, x)
        st = {"carry": (c["C"][r], c["n"][r], c["m"][r]), "conv": c["conv"][r]}
        o, st = S.mlstm_decode_step(blk.mixer, h, st, cfg)
        for name, new in zip(("C", "n", "m", "conv"), (*st["carry"],
                                                         st["conv"])):
            c[name][r].copy_(new)
        x = x + o
    x = L.rmsnorm(params.final_norm, x)
    return x[:, 0] @ params.lm_head, cache


def _last_logits(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """lm_head on the last position only (the norm is per position)."""
    return (L.rmsnorm(params.final_norm, x[:, -1:]) @ params.lm_head)[:, 0]


def _forward_prefill_dense(params: Transformer, cfg: ModelConfig,
                           batch: dict):
    """Prefill attention is the port's flash kernel on the card, where
    `repro` ran its materialised `L.attention` (F3's documented divergence,
    held at the reference's tolerances).  q and k come out of `apply_rope`
    and v out of a reshape, all contiguous, so the bf16 kernel's 16-byte row
    check holds at every head width the configs have (d 120: 240-byte rows)
    and no copy is made."""
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    B, S = tokens.shape
    W = cfg.window
    positions = torch.arange(S, device=tokens.device)
    rope = L.rope_table(positions[None], cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    x = _embed(params, cfg, tokens)
    for blk in params.blocks:
        h = L.rmsnorm(blk.norm1, x)
        q, k, v = L.gqa_project_qkv(blk.attn, h, cfg, rope)
        o = ops.flash_attention(q, k, v, causal=True, window=W)
        if W is not None and S > W:
            # the last W rows, rolled so that position p sits at slot p % W
            # (`repro`'s ring-aligned prefill cache)
            k, v = (torch.roll(t[:, -W:], S % W, dims=1) for t in (k, v))
        ks.append(k)
        vs.append(v)
        x = x + o.reshape(B, S, cfg.num_heads * cfg.head_dim) @ blk.attn.w_o
        h = L.rmsnorm(blk.norm2, x)
        x = x + L.ffn(blk.ffn, h, cfg.ffn_act)
    cache = ({"k": torch.stack(ks), "v": torch.stack(vs)},)
    return _last_logits(params, x), cache, torch.zeros((), device=x.device)


def _forward_prefill_mlstm(params: Transformer, cfg: ModelConfig,
                           batch: dict):
    """The carry comes out of the chunked mixer; the conv window is the last
    dc-1 rows of the pre-conv input, projected again from those rows of the
    block's input alone (each row's projection is its own)."""
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    dp = cfg.mlstm_proj_factor * cfg.d_model
    tail = cfg.ssm_conv_dim - 1
    leaves = {"C": [], "n": [], "m": [], "conv": []}
    x = _embed(params, cfg, tokens)
    for blk in params.blocks:
        h = L.rmsnorm(blk.norm1, x)
        o, carry = S.mlstm_mixer(blk.mixer, h, cfg)
        conv = h[:, -tail:] @ blk.mixer.up_proj[:, :dp]
        for name, t in zip(leaves, (*carry, conv)):
            leaves[name].append(t)
        x = x + o
    cache = ({k: torch.stack(v) for k, v in leaves.items()},)
    return _last_logits(params, x), cache, torch.zeros((), device=x.device)
