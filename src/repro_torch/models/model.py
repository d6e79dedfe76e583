"""Model core for the port: config, init, KV cache and the forward pass.

Two patterns are ported:
  * dense GQA `(("attn", "dense"),)` in `decode` mode (one token against the
    cache, the online-serving hot path);
  * mLSTM `(("mlstm", "none"),)` in `train` mode (full-sequence logits, the
    offline train step of the profiling catalog).
Blocks are an `nn.ModuleList` of per-layer modules, run by a Python loop; the
cache keeps `repro`'s layout, a tuple over pattern positions of {"k", "v"}
tensors with a leading `repeats` dimension.
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
        dense = (self.pattern == DENSE_PATTERN and self.window is None
                 and self.ffn_act == "silu")
        if not (dense or self.pattern == MLSTM_PATTERN):
            raise NotImplementedError(
                f"{self.name}: only the dense full-attention pattern "
                f"{DENSE_PATTERN} with a SiLU FFN and the mLSTM pattern "
                f"{MLSTM_PATTERN} are ported; see ROADMAP.md")

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
    """Decode cache: tuple over pattern positions of {"k", "v"}, each
    (repeats, batch, kv_capacity, Hk, head_dim) zeros in cfg.dtype."""
    dev = resolve_device(device)
    shape = (cfg.repeats, batch, kv_capacity, cfg.num_kv_heads, cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                  "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
                 for _ in cfg.pattern)


def _embed(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor):
    # the scale is rounded to the model dtype first, as JAX's weak float is
    return params.embed[tokens] * torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=cfg.dtype)


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            mode: str = "decode", cache: tuple | None = None, pos=None):
    """decode (dense pattern): batch={"tokens": (B, 1)}, cache, pos (int or
    (B,)) -> (logits (B, Vpad), cache).
    train (mLSTM pattern): batch={"tokens": (B, S)} -> (logits (B, S, Vpad),
    aux), aux a zero scalar (no MoE).

    In decode the cache is updated in place: `repro` wrote a new cache
    functionally, which at full width would copy every layer's cache on
    every step.  The returned cache is the object passed in."""
    if mode == "train" and cfg.pattern == MLSTM_PATTERN:
        return _forward_train_mlstm(params, cfg, batch)
    if mode != "decode" or cache is None or cfg.pattern != DENSE_PATTERN:
        raise NotImplementedError(
            f"mode={mode!r} for pattern {cfg.pattern}: only decode against a "
            "cache (dense) and train (mLSTM) are ported; see ROADMAP.md")
    dev = params.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    B = tokens.shape[0]
    H, dh = cfg.num_heads, cfg.head_dim
    kc_all, vc_all = cache[0]["k"], cache[0]["v"]
    # kv_len = pos + 1 is checked against the capacity once, on the host; a
    # pos on the card is copied there first (one wait for the card), so that
    # a position past the cache raises instead of being clamped by the kernel
    lens = kv_lengths(torch.as_tensor(pos).cpu() + 1, B, kc_all.shape[2], dev)
    pos_b = lens.long() - 1                                  # (B,)
    rope = L.rope_table(pos_b[:, None], dh, cfg.rope_theta)
    rows = torch.arange(B, device=dev)

    x = _embed(params, cfg, tokens)
    for r, blk in enumerate(params.blocks):
        h = L.rmsnorm(blk.norm1, x)
        q, k, v = L.gqa_project_qkv(blk.attn, h, cfg, rope)
        kc, vc = kc_all[r], vc_all[r]
        kc[rows, pos_b] = k[:, 0]
        vc[rows, pos_b] = v[:, 0]
        # every Sq == 1 attention takes the decode kernel, MHA included
        # (`repro` sent MHA down its dense path: the same function)
        o = ops.decode_attention(q, kc, vc, lens)
        x = x + o.reshape(B, 1, H * dh) @ blk.attn.w_o
        h = L.rmsnorm(blk.norm2, x)
        x = x + L.ffn(blk.ffn, h)
    x = L.rmsnorm(params.final_norm, x)
    return x[:, 0] @ params.lm_head, cache


def _forward_train_mlstm(params: Transformer, cfg: ModelConfig, batch: dict):
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    x = _embed(params, cfg, tokens)
    for blk in params.blocks:
        h = L.rmsnorm(blk.norm1, x)
        o, _ = S.mlstm_mixer(blk.mixer, h, cfg)
        x = x + o
    x = L.rmsnorm(params.final_norm, x)
    return x @ params.lm_head, torch.zeros((), device=x.device)
