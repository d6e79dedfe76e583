"""int8 KV-cache quantization (serving memory and bandwidth lever), a port
of `repro/serving/kv_quant.py` in plain PyTorch.

Decode is bound by the bytes of its KV cache; int8 values with a scale per
(token, head) halve that traffic against bf16 and quarter it against fp32
(KIVI/KVQuant-style, per token, after the rotary embedding).  `repro`
computes these in jnp, outside any Pallas kernel, so they stay plain torch:
a standalone utility and a quantized decode attention that dequantizes the
whole cache and then attends, held to `repro`'s bounds in the tests.
"""
from __future__ import annotations

import torch


def kv_quantize(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """kv: (B, S, H, d) -> (int8 values, fp16 scales (B, S, H, 1)):
    symmetric absmax scaling per (token, head), rounded half to even."""
    kf = kv.float()
    scale = kf.abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(kf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 values from `kv_quantize`'s int8 values and scales."""
    return q.float() * scale.float()


def quantized_cache_bytes(B: int, S: int, H: int, d: int) -> int:
    """Bytes of a quantized cache: int8 values and fp16 scales."""
    return B * S * H * d * 1 + B * S * H * 2


def decode_attention_quantized(q: torch.Tensor, k_q: torch.Tensor,
                               k_scale: torch.Tensor, v_q: torch.Tensor,
                               v_scale: torch.Tensor, kv_len) -> torch.Tensor:
    """Decode attention over an int8-quantized cache.  q: (B, 1, H, d);
    k_q, v_q: (B, S, Hk, d) int8 with (B, S, Hk, 1) scales; kv_len: valid
    rows (int or (B,)).  The cache is dequantized whole, then attended in
    fp32 with G = H / Hk query heads a KV head; returns q's type."""
    B, _, H, d = q.shape
    Skv, Hk = k_q.shape[1], k_q.shape[2]
    G = H // Hk
    k = kv_dequantize(k_q, k_scale)
    v = kv_dequantize(v_q, v_scale)
    qg = q.reshape(B, 1, Hk, G, d).float() * (d ** -0.5)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    mask = torch.arange(Skv, device=q.device)[None, :] < lens.expand(B, 1)
    scores = torch.where(mask[:, None, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(B, 1, H, d).to(q.dtype)
