"""Model core for the port: config, init, KV cache and the decode forward.

Ported for the dense GQA pattern `(("attn", "dense"),)`, in `decode` mode
(one token against the cache, the online-serving hot path).  Blocks are an
`nn.ModuleList` of per-layer modules, run by a Python loop; the cache keeps
`repro`'s layout, a tuple over pattern positions of {"k", "v"} tensors with a
leading `repeats` dimension.
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

PORTED_PATTERN = (("attn", "dense"),)


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
    pattern: tuple = PORTED_PATTERN
    window: int | None = None         # sliding window (None = full)
    rope_theta: float = 10000.0
    ffn_act: str = "silu"
    dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 256

    def __post_init__(self):
        if (self.pattern != PORTED_PATTERN or self.window is not None
                or self.ffn_act != "silu"):
            raise NotImplementedError(
                f"{self.name}: only the dense full-attention pattern "
                f"{PORTED_PATTERN} with a SiLU FFN is ported; see ROADMAP.md")

    @property
    def repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = L.GQA(cfg, device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.dtype, device)
        self.ffn = L.FFN(cfg.d_model, cfg.d_ff, cfg.dtype, device)


class Transformer(nn.Module):
    """Parameters (uninitialised) on `device`; names follow `repro`'s tree,
    with `blocks.<layer>` in place of the stacked `blocks[0]`."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, V = cfg.d_model, cfg.padded_vocab
        self.embed = L.param((V, d), cfg.dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(d, cfg.dtype, device)
        self.lm_head = L.param((d, V), cfg.dtype, device)


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random weights on the generator's device, drawn as `repro` draws them:
    embedding N(0, 0.02), projections truncated normal (+-2 std) with
    std 1/sqrt(fan_in), norm scales 1.  Drawn in fp32, stored in cfg.dtype."""
    model = Transformer(cfg, generator.device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name == "embed":
                w.normal_(0.0, 0.02, generator=generator)
            else:
                std = 1.0 / math.sqrt(p.shape[0])
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


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            mode: str = "decode", cache: tuple | None = None, pos=None):
    """decode: batch={"tokens": (B, 1)}, cache, pos (int or (B,)) ->
    (logits (B, Vpad), cache).

    The cache is updated in place: `repro` wrote a new cache functionally,
    which at full width would copy every layer's cache on every step.  The
    returned cache is the object passed in."""
    if mode != "decode" or cache is None:
        raise NotImplementedError(
            f"mode={mode!r}: only decode against a cache is ported; "
            "see ROADMAP.md")
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

    # the scale is rounded to the model dtype first, as JAX's weak float is
    x = params.embed[tokens] * torch.tensor(math.sqrt(cfg.d_model),
                                            dtype=cfg.dtype)
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
