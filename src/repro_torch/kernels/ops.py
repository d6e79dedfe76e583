"""Public entry points for the port's kernels, dispatched by tensor device.

A CUDA tensor always goes to the hand-written kernel (which raises if it
cannot build or launch); a CPU tensor goes to the kernel's plain PyTorch
version.  `repro.kernels.ops` switched the Pallas kernels to interpret mode
off the TPU instead; the port has no such switch.
"""
from __future__ import annotations

import torch

from . import decode_attention as _decode


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """q: (B,1,H,d); caches: (B,Skv,Hk,d); kv_len: valid entries (int or
    (B,), each >= 1).  Returns (B,1,H,d) in q.dtype."""
    if q.device.type == "cuda":
        return _decode.decode_attention_cuda(q, k_cache, v_cache, kv_len)
    if q.device.type == "cpu":
        return _decode.decode_attention_plain(q, k_cache, v_cache, kv_len)
    raise ValueError(f"no decode_attention for device {q.device}")
